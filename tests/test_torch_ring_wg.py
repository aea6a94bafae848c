"""K7's ``wgmma_sp`` step on the CPU: its plain version, the rings on it
against the JAX Pallas rings, the windows it reads, the rule that picks it,
the ring-graph key and the plan it shares with K3.

The step contracts a window of the operand that ``ops.sparse24.pack_wg``
packed once into the container; its plain version
(``ring_kernel.ring_step_wg_plain``) decodes that window from the packed
words, so the window addressing of the kernel runs here. JAX runs on the
8-device virtual CPU mesh that ``tests/conftest.py`` forces, its Pallas
rings in interpret mode as ``tests/test_torch_parallel.py`` runs them; the
port runs on ``make_mesh(devices=["cpu"] * P)``. Both get the same bf16
operands, compressed by JAX and converted bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from sparsifyme_tpu.ops import prune as jprune
from sparsifyme_tpu.ops import sparse24 as js
from sparsifyme_tpu.parallel import ring_kernel as jrk
from sparsifyme_tpu_torch.containers import Sparse24
from sparsifyme_tpu_torch.convert import sparse24_from_numpy
from sparsifyme_tpu_torch.models.resnet_shapes import resnet_conv_shapes
from sparsifyme_tpu_torch.ops.kernels import spmm24_kernel as k3
from sparsifyme_tpu_torch.ops.sparse24 import pack_wg
from sparsifyme_tpu_torch.parallel import mesh as tmesh
from sparsifyme_tpu_torch.parallel import ring_graph
from sparsifyme_tpu_torch.parallel import ring_kernel as trk

BF16_TOL = 2e-2
# two rings on the two plain steps: the same f32 terms summed, where the
# product's blocking may differ by the operands' layout, to an f32
# rounding at most
SAME_TOL = 1e-6


def _operands(rng, rows, k, n, batch=0):
    """(JAX Sparse24, JAX B, port Sparse24 packed with pack_wg, port B) of
    one pruned bf16 A ``[rows, k]`` (``[batch, rows / batch, k]``) and B."""
    a = rng.normal(size=(rows, k)).astype(np.float32)
    if batch:
        a = a.reshape(batch, rows // batch, k)
    b = jnp.asarray(rng.normal(size=(k, n)), jnp.bfloat16)
    s = js.compress_24(jprune.prune_24(jnp.asarray(a, jnp.bfloat16))[0])
    q = sparse24_from_numpy(np.asarray(s.values0), np.asarray(s.values1),
                            np.asarray(s.codes), s.shape, device="cpu")
    tb = torch.from_numpy(np.asarray(b).astype(np.float32)).to(
        torch.bfloat16)
    return s, b, pack_wg(q), tb


def _rel(want, got):
    ref = np.asarray(jnp.asarray(want, jnp.float32))
    got = got.float().numpy()
    assert got.shape == ref.shape
    return np.abs(got - ref).max() / np.abs(ref).max()


def _mesh(p):
    return tmesh.make_mesh((p,), ("model",), devices=["cpu"] * p)


@pytest.fixture
def spy(monkeypatch):
    """Counts the calls of each plain step the rings take on CPU ranks."""
    calls = {"wgmma_sp": 0, "mma_sp": 0}
    for design, name in (("wgmma_sp", "ring_step_wg_plain"),
                         ("mma_sp", "ring_step_plain")):
        real = getattr(trk, name)

        def step(*a, real=real, design=design, **kw):
            calls[design] += 1
            return real(*a, **kw)
        monkeypatch.setattr(trk, name, step)
    return calls


# --- the plain step ----------------------------------------------------------

@pytest.mark.parametrize("p,r,i,c0,mt", [
    (4, 1, 0, 0, 256),    # a whole shard, the rank's own k-slice
    (4, 1, 3, 0, 256),    # the k-slice of rank 2
    (4, 3, 1, 128, 128),  # the second m-tile of the last rank
    (2, 0, 1, 0, 128),    # two ranks, the first m-tile
    (1, 0, 0, 0, 256),    # one rank: the whole operand
])
@pytest.mark.parametrize("first,last", [(True, False), (False, False),
                                        (False, True), (True, True)])
@pytest.mark.parametrize("odtype", [torch.bfloat16, torch.float32])
def test_ring_step_wg_plain_is_ring_step_plain(rng, p, r, i, c0, mt, first,
                                               last, odtype):
    """On rank r's window of the container's operand (rank r starts at
    m-tile r * mloc / 128 of it, as on a one-card mesh) the plain wgmma_sp
    step writes what the plain mma_sp step writes on the rank's planes:
    the accumulator on middle steps, C on the last, nothing outside the
    window, bit for bit."""
    mloc, k4s, n = 256, 16 * (1 + r % 2), 64
    _, _, q, _ = _operands(rng, mloc * p, 4 * k4s * p, n)
    planes = [x[:, r * mloc:(r + 1) * mloc]
              for x in (q.values0, q.values1, q.codes)]
    slot = torch.randn(4 * k4s, n).to(torch.bfloat16)
    acc0 = torch.randn(mloc, n)
    outs = []
    for fn, a in ((trk.ring_step_wg_plain, (q.wg.packed, r * mloc // 128)),
                  (trk.ring_step_plain, planes)):
        acc, out = acc0.clone(), torch.zeros(mloc, n, dtype=odtype)
        fn(*a, slot, acc, out, src=(r - i) % p, c0=c0, mt=mt, first=first,
           last=last)
        outs.append((acc, out))
    (acc, out), (acc_p, out_p) = outs
    # exact: both decode the same bf16 values to f32 and call the same
    # product on operands of the same layout
    assert torch.equal(acc, acc_p) and torch.equal(out, out_p)
    if last:
        assert torch.equal(acc, acc0)
        assert not out[:c0].any() and not out[c0 + mt:].any()
    else:
        assert torch.equal(acc[:c0], acc0[:c0])
        assert torch.equal(acc[c0 + mt:], acc0[c0 + mt:])
        assert not out.any()


def test_ring_step_wg_plain_refuses_windows_off_the_operand(rng):
    _, _, q, _ = _operands(rng, 512, 256, 64)  # ktp 4, 4 m-tiles
    wg = q.wg.packed
    slot = torch.zeros(128, 64, dtype=torch.bfloat16)  # two k-steps
    acc = torch.zeros(256, 64)
    for kw in (dict(src=2, c0=0, mt=256),      # k-steps 4, 5
               dict(src=0, c0=64, mt=128),     # off the 128-row tiles
               dict(src=0, c0=128, mt=256)):   # past the rank's rows
        with pytest.raises(ValueError, match="outside"):
            trk.ring_step_wg_plain(wg, 0, slot, acc, acc, first=True,
                                   last=False, **kw)
    with pytest.raises(ValueError, match="outside"):
        trk.ring_step_wg_plain(wg, 3, slot, acc, acc, src=0, c0=0, mt=256,
                               first=True, last=False)
    with pytest.raises(ValueError, match="k %"):
        trk.ring_step_wg_plain(wg, 0, slot[:96], acc, acc, src=0, c0=0,
                               mt=256, first=True, last=False)


# --- the rings against JAX ---------------------------------------------------

@pytest.mark.parametrize("p", [2, 4])
@pytest.mark.parametrize("n", [64, 128])
@pytest.mark.parametrize("tiled", [False, True])
def test_rings_on_wgmma_sp_match_pallas(rng, spy, p, n, tiled):
    """Both rings with design="wgmma_sp" on ["cpu"] * P ranks (every step
    the plain wgmma_sp step, reading its window of the packed operand)
    against spmm_24_ring_pallas / spmm_24_ring_tiled_pallas interpreted,
    bf16 operands, bf16 and f32 C (2e-2); the tiled rings in m-tiles of
    128 rows, two a rank."""
    rows, k = 256 * p, 64 * p * (1 if tiled else 2)
    s, b, q, tb = _operands(rng, rows, k, n, batch=2)
    jm = JMesh(np.array(jax.devices()[:p]), ("model",))
    for jdt, tdt in ((jnp.bfloat16, torch.bfloat16),
                     (jnp.float32, torch.float32)):
        if tiled:
            want = jrk.spmm_24_ring_tiled_pallas(s, b, jm, "model",
                                                 out_dtype=jdt, m_tile=128)
            got = trk.spmm_24_ring_tiled(q, tb, _mesh(p), "model",
                                         out_dtype=tdt, m_tile=128,
                                         design="wgmma_sp")
        else:
            want = jrk.spmm_24_ring_pallas(s, b, jm, "model", out_dtype=jdt)
            got = trk.spmm_24_ring_explicit(q, tb, _mesh(p), "model",
                                            out_dtype=tdt, design="wgmma_sp")
        assert got.dtype == tdt and _rel(want, got) < BF16_TOL
    assert spy == {"wgmma_sp": 2 * p * p * (2 if tiled else 1),
                   "mma_sp": 0}


@pytest.mark.parametrize("tiled", [False, True])
def test_rings_pick_wgmma_sp_where_the_container_is_packed(rng, spy, tiled):
    """design=None takes the wgmma_sp step on a packed container and the
    mma_sp step on the same planes unpacked; the two rings agree."""
    p = 2
    _, _, q, tb = _operands(rng, 512, 256, 64)
    fn = trk.spmm_24_ring_tiled if tiled else trk.spmm_24_ring_explicit
    kw = dict(m_tile=128) if tiled else {}
    got = fn(q, tb, _mesh(p), "model", out_dtype=torch.float32, **kw)
    steps = p * p * (2 if tiled else 1)
    assert spy == {"wgmma_sp": steps, "mma_sp": 0}
    bare = Sparse24(q.values0, q.values1, q.codes, shape=q.shape)
    want = fn(bare, tb, _mesh(p), "model", out_dtype=torch.float32, **kw)
    assert spy == {"wgmma_sp": steps, "mma_sp": steps}
    assert torch.allclose(got, want, rtol=0,
                          atol=SAME_TOL * float(want.abs().max()))


# --- the windows the kernel reads --------------------------------------------

@pytest.mark.parametrize("p,mloc,mt,n,k4s", [
    (1, 256, 256, 64, 16), (2, 256, 128, 128, 32), (4, 512, 128, 64, 16),
    (3, 384, 384, 256, 48), (8, 128, 128, 128, 16),
    (4, 6272, 6272, 256, 64),  # R, the plain route
    (4, 6272, 896, 256, 64),   # R, the tiled route
])
def test_ring_wg_walk_covers_the_product_once(p, mloc, mt, n, k4s):
    """One ring reads every (k-step, m-tile, n-tile) block of the product
    exactly once; each (rank, step, m-tile) only k-steps of its slot's
    k-slice and m-tiles of the rank's m-tile window."""
    walk = trk.ring_wg_walk(p, mloc, mt, n, k4s)
    assert set(walk) == {(r, i, j) for r in range(p) for i in range(p)
                         for j in range(mloc // mt)}
    seen = {}
    kts = k4s // 16
    for (r, i, j), blocks in walk.items():
        src = (r - i) % p
        mt0 = (r * mloc + j * mt) // 128
        for kt, m_tile, n_tile in blocks:
            assert src * kts <= kt < (src + 1) * kts
            assert mt0 <= m_tile < mt0 + mt // 128
            seen[kt, m_tile, n_tile] = seen.get((kt, m_tile, n_tile), 0) + 1
    n_tiles = n // trk.ring_wg_plan(mt, n, 4 * k4s).bn
    assert set(seen.values()) == {1}
    assert set(seen) == {(kt, m, t) for kt in range(p * kts)
                         for m in range(p * mloc // 128)
                         for t in range(n_tiles)}


def test_ring_wg_plan_adds_the_accumulator_to_the_floor():
    """K7's plan is K3's wg_plan with 8 B a C element in its byte floor,
    choosing between 128 and 64 columns: at R the plain route's 98 units
    run in one split of 128 columns, the tiled route's window in 28 units
    of 64 (14 of 128 would leave 118 SMs idle)."""
    assert tuple(trk.ring_wg_plan(6272, 256, 256)) == (128, 1, 4, 98, 98)
    assert tuple(trk.ring_wg_plan(896, 256, 256)) == (64, 1, 4, 28, 28)
    assert tuple(k3.wg_plan(896, 256, 256, extra_bytes=8.0 * 896 * 256)) \
        == (128, 1, 4, 14, 14)
    for mt, n in ((6272, 256), (896, 256), (256, 128), (128, 64)):
        assert trk.ring_wg_plan(mt, n, 256) == k3.wg_plan(
            mt, n, 256, extra_bytes=8.0 * mt * n, widths=(128, 64))
    assert tuple(trk.ring_wg_plan(128, 64, 1024, sms=132)) == tuple(
        k3.wg_plan(128, 64, 1024, 132, extra_bytes=8.0 * 128 * 64))


# --- the rule ----------------------------------------------------------------

@pytest.mark.parametrize("case,match", [
    ("no wg", "carries no wg"),
    ("f32 b", "bf16 in"),
    ("f16 out", "bf16 in"),
    ("rows a rank", "rows a rank 64"),
    ("m-tile", "m-tile 64"),
    ("n", "n 48"),
    ("k4 a rank", "k4 a rank 8"),
])
def test_ring_wg_refusal_keeps_the_mma_sp_step(rng, spy, case, match):
    """Each call ring_wg_refusal refuses runs the mma_sp step with
    design=None, and raises with a forced design="wgmma_sp", before any
    step."""
    p, rows, k, n, kw, out = 2, 512, 256, 64, {}, torch.float32
    if case == "rows a rank":
        p, rows = 4, 256
    elif case == "n":
        n = 48
    elif case == "k4 a rank":
        p, k = 4, 128
    _, _, q, tb = _operands(rng, rows, k, n)
    if case == "no wg":
        q = Sparse24(q.values0, q.values1, q.codes, shape=q.shape)
    elif case == "f32 b":
        tb = tb.float()
    elif case == "f16 out":
        out = torch.float16
    elif case == "m-tile":
        kw = dict(m_tile=64)
    fn = trk.spmm_24_ring_tiled if kw else trk.spmm_24_ring_explicit
    with pytest.raises(ValueError, match=match):
        fn(q, tb, _mesh(p), "model", out_dtype=out, design="wgmma_sp", **kw)
    assert spy == {"wgmma_sp": 0, "mma_sp": 0}
    got = fn(q, tb, _mesh(p), "model", out_dtype=out, **kw)
    assert got.dtype == out
    steps = p * p * (rows // p // 64 if kw else 1)
    assert spy == {"wgmma_sp": 0, "mma_sp": steps}


@pytest.mark.parametrize("design", [None, "wgmma_sp", "mma_sp"])
def test_rings_refuse_a_stale_operand(rng, design):
    _, _, q, tb = _operands(rng, 512, 256, 64)
    q.values1.mul_(1.0)  # an in-place write after pack_wg
    for fn in (trk.spmm_24_ring_explicit, trk.spmm_24_ring_tiled):
        with pytest.raises(ValueError, match="stale"):
            fn(q, tb, _mesh(2), "model", design=design)


def test_rings_refuse_an_unknown_design(rng):
    _, _, q, tb = _operands(rng, 512, 256, 64)
    with pytest.raises(ValueError, match="is not one of"):
        trk.spmm_24_ring_explicit(q, tb, _mesh(2), "model", design="wgmma")


# --- the ring-graph key ------------------------------------------------------

def test_graph_key_tells_the_designs_and_operands_apart(rng):
    """A graph captured on one design, or on one packed operand, never
    replays for another: the key holds both."""
    _, _, q, tb = _operands(rng, 512, 256, 64)
    kw = dict(shape=q.shape, out_dtype=torch.float32,
              route="spmm_24_ring_explicit", m_tile=256,
              devices=(torch.device("cpu"),) * 2,
              step=trk.ring_step_wg_plain)

    def key(**over):
        return ring_graph.graph_key(q.values0, q.values1, q.codes, tb,
                                    **{**kw, **over})

    base = key(design="wgmma_sp", wg=q.wg.packed)
    assert key(design="wgmma_sp", wg=q.wg.packed) == base
    assert key(design="mma_sp", wg=q.wg.packed) != base
    assert key(design="mma_sp") != base
    assert key(design="wgmma_sp", wg=q.wg.packed.clone()) != base
    assert key(design="wgmma_sp", wg=q.wg.packed[:2]) != base
    assert key() == key(design="mma_sp", wg=None)


# --- K3's plans --------------------------------------------------------------

# wg_plan(b * m, n, k) at the 17 unique ResNet-50 shapes (b = 32), as K3's
# wgmma_sp route plans them: (bn, splits, kps, units, grid)
K3_PLANS = {
    (12544, 64, 147): (64, 1, 3, 3136, 132),
    (12544, 64, 64): (64, 1, 1, 3136, 132),
    (12544, 64, 576): (64, 1, 9, 3136, 132),
    (12544, 256, 64): (128, 1, 1, 6272, 132),
    (12544, 64, 256): (64, 1, 4, 3136, 132),
    (12544, 128, 256): (128, 1, 4, 3136, 132),
    (3136, 128, 1152): (128, 1, 18, 784, 132),
    (3136, 512, 128): (128, 1, 2, 3136, 132),
    (3136, 128, 512): (128, 1, 8, 784, 132),
    (3136, 256, 512): (128, 1, 8, 1568, 132),
    (784, 256, 2304): (128, 1, 36, 392, 132),
    (784, 1024, 256): (128, 1, 4, 1568, 132),
    (784, 256, 1024): (128, 1, 16, 392, 132),
    (784, 512, 1024): (128, 1, 16, 784, 132),
    (196, 512, 4608): (128, 1, 72, 196, 132),
    (196, 2048, 512): (128, 1, 8, 784, 132),
    (196, 512, 2048): (128, 1, 32, 196, 132),
}


@pytest.mark.parametrize("shape", list(K3_PLANS))
def test_wg_plan_default_keeps_k3s_plans(shape):
    """wg_plan's new arguments (the bytes K7's accumulator adds, the
    column counts K7 chooses among) leave K3's plans as they were at their
    defaults."""
    m, n, k = shape
    assert shape in {(s.m, s.n, s.k) for s in resnet_conv_shapes("resnet50")}
    assert tuple(k3.wg_plan(32 * m, n, k)) == K3_PLANS[shape]
    assert k3.wg_plan(32 * m, n, k) == k3.wg_plan(32 * m, n, k,
                                                  extra_bytes=0.0)
    assert k3.wg_plan(32 * m, n, k) == k3.wg_plan(32 * m, n, k, widths=())


# --- bench/ring_probe.py ----------------------------------------------------

def test_ring_probe_forces_a_plan_and_restores_the_steps():
    """The probe's ``forced`` rebinds the wgmma_sp step's plan (or every
    step, to a no-op) inside its block only."""
    from sparsifyme_tpu_torch.bench import ring_probe

    plan, steps = trk.card_ring_wg_plan, [getattr(trk, n)
                                          for n in ring_probe.STEPS]
    with ring_probe.forced(64, 2):
        assert trk.card_ring_wg_plan(0, 896, 256, 256) == \
            k3.wg_forced_plan(896, 256, 256, 64, 2)
    with ring_probe.forced(none=True):
        assert all(getattr(trk, n).launches == 0 for n in ring_probe.STEPS)
        assert trk.ring_step_wg_cuda(None, src=0) is None
    assert trk.card_ring_wg_plan is plan
    assert [getattr(trk, n) for n in ring_probe.STEPS] == steps


def test_ring_probe_counts_each_steps_bytes():
    """A's window (1.125 B a logical element packed, 1.25 as planes), the
    slot, and 4 B a C element for each accumulator read or write, 2 for
    bf16 C."""
    from sparsifyme_tpu_torch.bench.ring_probe import N, step_bytes

    mt, k = 896, 256
    base = 2.0 * k * N
    assert step_bytes(mt, k, "wgmma_sp", True, False) == \
        1.125 * mt * k + base + 4 * mt * N
    assert step_bytes(mt, k, "mma_sp", False, False) == \
        1.25 * mt * k + base + 8 * mt * N
    assert step_bytes(mt, k, "wgmma_sp", False, True) == \
        1.125 * mt * k + base + 6 * mt * N
