"""Port parity: K3's ``wgmma_sp`` route on the CPU, against the JAX package.

The route's operand is derived once from the planes (``pack_wg``: the
plain ``pack_wgmma_sp`` on CPU planes) and carried in the container; the
route's plain version (``spmm24_wg_plain``) decodes that operand alone,
never the planes, so a packing fault shows here. Inputs are made with numpy
from a seed and go through both packages: the JAX ``spmm_24`` (Pallas
interpreted) on the same planes within 2e-2 relative to the largest
reference magnitude in bf16 (the two round at other places; the port
accumulates in f32). The rest holds the route's rules: the stale guard,
what ``pack_wg`` refuses, the ``design`` dispatch, the conversions and
shards that drop the operand, and the harness, tuner and plan that race
or take the route. The kernels themselves run on the card
(``tests/test_torch_cuda.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparsifyme_tpu.containers import Sparse24 as JS24
from sparsifyme_tpu.ops import prune as jprune
from sparsifyme_tpu.ops import sparse24 as js
from sparsifyme_tpu_torch import convert
from sparsifyme_tpu_torch import plan as tplan
from sparsifyme_tpu_torch.bench import harness, tune, tuning
from sparsifyme_tpu_torch.containers import Sparse24
from sparsifyme_tpu_torch.convert import tensor_from_numpy, tensor_to_numpy
from sparsifyme_tpu_torch.ops import sparse24 as ts
from sparsifyme_tpu_torch.ops.kernels import spmm24_kernel as k3
from sparsifyme_tpu_torch.parallel import mesh as tmesh
from sparsifyme_tpu_torch.parallel import spmm_sharded as tsh
from sparsifyme_tpu_torch.utils.shapes import LayerShape

BF16 = 2e-2


def _rel(out, ref) -> float:
    out, ref = (np.asarray(tensor_to_numpy(x) if isinstance(x, torch.Tensor)
                           else x, np.float32) for x in (out, ref))
    assert out.shape == ref.shape
    return float(np.abs(out - ref).max() / max(np.abs(ref).max(), 1e-30))


def _jax_planes(rng, m, k):
    """The JAX package's planes of a pruned bf16 ``[m, k]``."""
    a = jnp.asarray(rng.normal(size=(m, k)), jnp.bfloat16)
    return js.compress_24(jprune.prune_24(a)[0])


def _port(s) -> Sparse24:
    """The JAX container's planes in the port, bit for bit, on the CPU."""
    return convert.sparse24_from_numpy(
        np.asarray(s.values0), np.asarray(s.values1), np.asarray(s.codes),
        s.shape, device="cpu")


def _b(rng, k, n):
    return np.asarray(jnp.asarray(rng.normal(size=(k, n)), jnp.bfloat16))


@pytest.mark.parametrize("k", [64, 147, 1152])
@pytest.mark.parametrize("m", [128, 256])
@pytest.mark.parametrize("n", [64, 128])
def test_route_matches_the_jax_spmm_24(rng, k, m, n, monkeypatch):
    """``spmm_24`` on a container from ``pack_wg`` takes the route (its
    plain version on the CPU) and agrees with the JAX ``spmm_24`` on the
    same planes."""
    s = _jax_planes(rng, m, k)
    b = _b(rng, k, n)
    want = js.spmm_24(s, jnp.asarray(b), out_dtype=jnp.bfloat16)
    sw = ts.pack_wg(_port(s))
    calls = []
    real = ts.spmm24_wg_plain
    monkeypatch.setattr(ts, "spmm24_wg_plain",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    got = ts.spmm_24(sw, tensor_from_numpy(b, "cpu"))
    assert calls == [1]
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (m, n)
    assert _rel(got, want) < BF16


@pytest.mark.parametrize("k,m", [(64, 128), (147, 256), (1152, 128)])
def test_plain_decode_matches_jax_decompress(rng, k, m):
    """``spmm24_wg_plain`` decodes the packed words into A and multiplies
    in f32: the JAX ``decompress_24(s) @ b`` in f32, within f32 rounding."""
    s = _jax_planes(rng, m, k)
    b = _b(rng, k, 64)
    want = np.asarray(js.decompress_24(s), np.float32) @ np.asarray(
        b, np.float32)
    sw = ts.pack_wg(_port(s))
    got = k3.spmm24_wg_plain(sw.wg.packed, tensor_from_numpy(b, "cpu"), m=m,
                             k_logical=k, out_dtype=torch.float32)
    assert _rel(got, want) < 1e-5
    dense = k3.wg_dense(sw.wg.packed)[:k].T
    assert np.array_equal(tensor_to_numpy(dense),
                          np.asarray(js.decompress_24(s), np.float32))


@pytest.mark.parametrize("k4,m", [(16, 128), (7, 256), (288, 128)])
def test_plain_pack_round_trips_bit_for_bit(rng, k4, m):
    s = _jax_planes(rng, m, 4 * k4)
    v0, v1, codes = (tensor_from_numpy(np.asarray(p), "cpu")
                     for p in (s.values0, s.values1, s.codes))
    v0, v1, codes = v0[:k4], v1[:k4], codes[:k4]
    packed = k3.pack_wgmma_sp(v0, v1, codes)
    assert packed.shape == (-(-k4 // 16), m // 128, k3.WG_WORDS)
    for got, want in zip(k3.unpack_wgmma_sp(packed, k4), (v0, v1, codes)):
        assert got.dtype == want.dtype and torch.equal(got, want)


def test_stale_operand_raises(rng):
    """An in-place write to a plane, or a plane swapped in by
    ``dataclasses.replace`` (which copies ``wg``), makes ``spmm_24`` raise
    whatever the design; packing again clears it."""
    s = _port(_jax_planes(rng, 128, 64))
    b = tensor_from_numpy(_b(rng, 64, 64), "cpu")
    sw = ts.pack_wg(s)
    ts.spmm_24(sw, b)
    swapped = dataclasses.replace(sw, values0=sw.values0.clone())
    with pytest.raises(ValueError, match="stale"):
        ts.spmm_24(swapped, b)
    sw.codes.add_(0)
    for design in (None, "wgmma_sp", "mma_sp"):
        with pytest.raises(ValueError, match="stale"):
            ts.spmm_24(sw, b, design=design)
    again = ts.pack_wg(sw)
    assert torch.equal(ts.spmm_24(again, b), ts.spmm_24(s, b, design=None))


def test_pack_wg_refuses_what_the_route_cannot_take(rng):
    """``pack_wg`` raises with ``pack_refusal``'s reason, which the models'
    set-up asks before it packs."""
    from sparsifyme_tpu_torch.ops.sparse24 import pack_refusal

    a = torch.from_numpy(rng.normal(size=(256, 128)).astype(np.float32))
    for bad, match in ((ts.prune_compress_24(a.to(torch.bfloat16), fold=2),
                        "fold"),
                       (ts.prune_compress_24(a[:200].to(torch.bfloat16)),
                        "128"),
                       (ts.prune_compress_24(a), "bf16")):
        assert match in pack_refusal(bad)
        with pytest.raises(ValueError, match=match):
            ts.pack_wg(bad)
    s = ts.prune_compress_24(a.to(torch.bfloat16))
    assert pack_refusal(s) is None
    assert s.wg is None and ts.pack_wg(s).wg.packed.shape == (2, 2, 2304)


REFUSED = [dict(transpose_out=True), dict(alpha=0.5),
           dict(beta=1.0, c=True), dict(out_dtype=torch.float32),
           dict(packed_codes=True), dict(tile=2)]


@pytest.mark.parametrize("kw", REFUSED,
                         ids=["tout", "alpha", "c", "f32", "packed", "tile"])
def test_design_dispatch(rng, kw, monkeypatch):
    """``None`` takes the route only on a container with ``wg`` and a call
    it takes, the ``mma_sp`` tile otherwise; a forced ``"wgmma_sp"``
    raises on a call it cannot take and never falls back."""
    s = _port(_jax_planes(rng, 128, 128))
    b = tensor_from_numpy(_b(rng, 128, 64), "cpu")
    sw = ts.pack_wg(s)
    kw = dict(kw)
    if kw.pop("c", False):
        kw["c"] = torch.ones((128, 64))
    calls = []
    real = ts.spmm24_wg_plain

    def spy(*args, **kwargs):
        calls.append(args[0].shape)
        return real(*args, **kwargs)

    monkeypatch.setattr(ts, "spmm24_wg_plain", spy)
    assert ts.spmm24_design(sw, b) == "wgmma_sp"
    assert ts.spmm24_design(s, b) == "mma_sp"
    ts.spmm_24(sw, b)
    ts.spmm_24(s, b)
    ts.spmm_24(sw, b, design="mma_sp")
    assert len(calls) == 1
    assert ts.spmm24_design(sw, b, **kw) == "mma_sp"
    ts.spmm_24(sw, b, **kw)
    assert len(calls) == 1
    with pytest.raises(ValueError, match="wgmma_sp"):
        ts.spmm_24(sw, b, design="wgmma_sp", **kw)
    with pytest.raises(ValueError, match="wgmma_sp"):
        ts.spmm_24(s, b, design="wgmma_sp")
    with pytest.raises(ValueError, match="design"):
        ts.spmm_24(sw, b, design="wmma")
    assert len(calls) == 1


def test_dispatch_on_b_and_fold(rng):
    """n % 64, an f32 b and fold=2 planes keep the mma_sp tile; forced,
    they raise. The route's wrapper refuses CPU tensors."""
    a = torch.from_numpy(rng.normal(size=(128, 64)).astype(np.float32)).to(
        torch.bfloat16)
    sw = ts.pack_wg(ts.prune_compress_24(a))
    for b in (torch.ones((64, 72), dtype=torch.bfloat16),
              torch.ones((64, 64))):
        assert ts.spmm24_design(sw, b) == "mma_sp"
        with pytest.raises(ValueError, match="wgmma_sp"):
            ts.spmm_24(sw, b, design="wgmma_sp")
    s2 = ts.prune_compress_24(a, fold=2)
    with pytest.raises(ValueError, match="fold"):
        ts.spmm_24(s2, torch.ones((64, 64), dtype=torch.bfloat16),
                   design="wgmma_sp")
    with pytest.raises(ValueError, match="card"):
        k3.spmm24_wg_cuda(sw.wg.packed, torch.ones((64, 64),
                                                   dtype=torch.bfloat16),
                          m=128, k_logical=64, out_dtype=torch.bfloat16)


def test_conversions_and_shards_drop_the_operand(rng):
    s = _port(_jax_planes(rng, 256, 64))
    sw = ts.pack_wg(s)
    back = convert.sparse24_from_numpy(*convert.sparse24_to_numpy(sw),
                                       device="cpu")
    assert back.wg is None and torch.equal(back.values0, sw.values0)
    mesh = tmesh.make_mesh((2,), ("model",), devices=["cpu"] * 2)
    shards = tsh.shard_planes(sw, mesh, "model")
    assert len(shards) == 2 and all(p.wg is None for p in shards)
    clone = sw.clone()
    assert clone.wg is not None and clone.values0.data_ptr() != \
        sw.values0.data_ptr()
    ts.check_wg(clone)  # bound to its own planes


def test_harness_races_the_route(rng, monkeypatch, tmp_path):
    """At a shape the route takes, the untuned race is wgmma_sp against
    the mma_sp tile in both layouts, the pack is timed as its own phase,
    and the winner's design is reported; a tuned wgmma_sp winner is raced
    alone (the default makes the same call)."""
    shape = LayerShape(64, 64, 64, 2)
    calls = {"wg": 0, "mma_sp": set()}
    real_wg, real_24 = ts.spmm24_wg_plain, harness.spmm_24

    def spy_wg(*args, **kw):
        calls["wg"] += 1
        return real_wg(*args, **kw)

    def spy_24(s, b, **kw):
        if ts.spmm24_design(s, b, **{k: v for k, v in kw.items()
                                     if k != "out_dtype"}) == "mma_sp":
            calls["mma_sp"].add(kw.get("transpose_out", False))
        return real_24(s, b, **kw)

    monkeypatch.setattr(ts, "spmm24_wg_plain", spy_wg)
    monkeypatch.setattr(harness, "spmm_24", spy_24)
    path = str(tmp_path / "t.json")
    tuning.save_table({}, path)
    monkeypatch.setattr(tuning, "TABLE_PATH", path)
    tuning._load.cache_clear()
    out = harness.bench_shape(shape, kernels=("gemm", "spmm24"), iters=1,
                              reps=1, device="cpu")
    assert calls["wg"] > 0 and calls["mma_sp"] == {False, True}
    assert out["pack_ms"] > 0 and out["pack_sol_ms"] > 0
    assert out["spmm24_design"] in ("wgmma_sp", "mma_sp")
    calls.update(wg=0, mma_sp=set())
    tuning.save_table({tuning.shape_key(*shape): {"spmm24": {
        "design": "wgmma_sp", "tile": None, "transpose_out": False,
        "packed": False, "fold": 1, "block_n": None, "splits": None,
        "ms": 1.0}, "card": "cpu"}}, path)
    out = harness.bench_shape(shape, kernels=("gemm", "spmm24"), iters=1,
                              reps=1, device="cpu")
    tuning._load.cache_clear()
    assert calls["wg"] > 0 and calls["mma_sp"] == set()
    assert out["spmm24_design"] == "wgmma_sp"
    results = harness.sweep([shape], kernels=("spmm24",), iters=1, reps=1,
                            device="cpu", verbose=False,
                            on_shape=lambda sh, r: calls.update(seen=sh))
    assert calls["seen"] == shape and results[0].spmm24_design
    assert "spmm24_design" in harness.CSV_COLUMNS


def test_tuner_lists_the_route_and_each_candidate_is_the_product(rng):
    """The tuner's wgmma_sp candidates (the plan's pick; with ``full``
    every width and split count), each held with the mma_sp ones to the
    JAX ``spmm_24``."""
    m, n, k, b = 64, 128, 256, 2
    short = tune.spmm24_candidates(m, n, k, b)
    full = tune.spmm24_candidates(m, n, k, b, full=True)
    wg = [c for c in full if c["design"] == "wgmma_sp"]
    assert [c for c in short if c["design"] == "wgmma_sp"] == wg[:1]
    # 4 k-steps: 3 splits of 2 would leave the last one empty
    assert {(c["block_n"], c["splits"]) for c in wg[1:]} == {
        (bn, sp) for bn in (64, 128) for sp in (1, 2, 4)}
    assert not any(c["design"] == "wgmma_sp" for c in
                   tune.spmm24_candidates(m, 72, k, b))
    assert not any(c["design"] == "wgmma_sp" for c in tune.spmm24_candidates(
        m, n, k, b, dtype=torch.float32))
    s = _jax_planes(rng, b * m, k)
    bm = _b(rng, k, n)
    want = np.asarray(js.spmm_24(s, jnp.asarray(bm), out_dtype=jnp.float32))
    ps = _port(s)
    pw = ts.pack_wg(ps)
    tb = tensor_from_numpy(bm, "cpu")
    for cand in full:
        if cand["fold"] == 2:
            continue  # held to JAX in tests/test_torch_tune.py
        fn, ops = harness.spmm24_call(cand, ps, None, tb, torch.bfloat16,
                                      pw)
        got = tensor_to_numpy(fn(*ops))
        got = got.T if cand["transpose_out"] else got.reshape(b * m, n)
        assert _rel(got, want) < BF16, cand


def test_spmma_plan_reads_the_design(rng, monkeypatch):
    """A bf16 plan on a shape the route takes packs in its compress step
    and takes the route, unless its table entry names mma_sp; an f32
    output keeps the mma_sp tile and no packing."""
    calls = []
    real = ts.spmm24_wg_plain

    def spy(*args, **kw):
        calls.append(1)
        return real(*args, **kw)

    monkeypatch.setattr(ts, "spmm24_wg_plain", spy)
    a = tensor_from_numpy(np.asarray(jnp.asarray(
        rng.normal(size=(2, 64, 128)), jnp.bfloat16)), "cpu")
    b = tensor_from_numpy(_b(rng, 128, 64), "cpu")
    cfg = tplan.SpmmaConfig(m=64, n=64, k=128, batch=2, out_dtype="bfloat16")
    for design, takes in (("wgmma_sp", True), (None, True),
                          ("mma_sp", False)):
        entry = {"design": design, "tile": None, "transpose_out": False,
                 "packed": False, "fold": 1}
        monkeypatch.setattr(tuning, "lookup",
                            lambda m, n, k, b=1, e=entry: {"spmm24": e})
        p = tplan.SpmmaPlan(cfg)
        assert p.design == design
        s = p.compress(p.prune(a))
        assert (s.wg is not None) == takes
        del calls[:]
        out = p.matmul(s, b)
        assert torch.equal(out, p(a, b)) and len(calls) == 2 * takes
        assert _rel(out, ts.spmm_24_reference(s, b)) < BF16
    p = tplan.SpmmaPlan(dataclasses.replace(cfg, out_dtype="float32"))
    assert p.compress(p.prune(a)).wg is None and p.design != "wgmma_sp"


def test_gradient_through_the_route_matches_jax_vjp(rng):
    """The route's forward, the planes' densifying backward: the gradients
    of the planes and b equal ``jax.vjp`` through the JAX ``spmm_24``."""
    m, k, n = 128, 128, 64
    s = _jax_planes(rng, m, k)
    jb = jnp.asarray(_b(rng, k, n))
    g = np.asarray(jnp.asarray(rng.normal(size=(m, n)), jnp.bfloat16))

    def jf(v0, v1, b):
        return js.spmm_24(JS24(v0, v1, s.codes, shape=s.shape), b,
                          interpret=True)

    _, vjp = jax.vjp(jf, s.values0, s.values1, jb)
    want = vjp(jnp.asarray(g))
    leaves = [tensor_from_numpy(np.asarray(x), "cpu").requires_grad_(True)
              for x in (s.values0, s.values1, jb)]
    codes = tensor_from_numpy(np.asarray(s.codes), "cpu")
    sw = ts.pack_wg(Sparse24(leaves[0], leaves[1], codes, shape=s.shape))
    out = ts.spmm_24(sw, leaves[2])
    assert out.grad_fn is not None
    assert ts.spmm24_design(sw, leaves[2]) == "wgmma_sp"
    got = torch.autograd.grad(out, leaves, tensor_from_numpy(g, "cpu"))
    for w, h, leaf in zip(want, got, leaves):
        assert h.dtype == leaf.dtype and _rel(h, w) < BF16
