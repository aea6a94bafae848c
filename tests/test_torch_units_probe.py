"""The probes of K3's tile (``sparsifyme_tpu_torch.bench.units_probe``)
against ``experiments/units.py`` on the CPU.

The JAX probe is imported as it is, with ``experiments/`` on ``sys.path``;
two of its module globals are swapped for the test: ``pl``, whose
``pallas_call`` runs in interpret mode, and ``time_kernel``, which calls the
jitted kernel once and keeps its output and operands (the probe's own
``PRNGKey(0)`` arrays, turned into numpy) instead of timing it. Nothing in
``experiments/`` changes.

* ``run_probe_fp1`` against :func:`units_probe.fp1_plain` (2e-2), and far
  from the product with b unpermuted (at least 0.5): this pins the
  quarter-major order of A's k axis; the kernel's own operand
  (:func:`units_probe.fp1_operand`) gives the same product through K3's
  plain version.
* ``run_probe(mode="expand")`` against the ``feed`` mode's plain version,
  at both ring depths (2e-2).

The JAX ``dot``, ``both``, ``parity`` and ``chain`` modes multiply VMEM
scratch that no step wrote, so JAX defines no output for them. Their
counterparts (``mma``, ``full`` at 4 and 2 stages, the serial ring) are
held to their own plain versions, on the card
(``tests/test_torch_cuda.py``); here the plain versions are held to what
they must reduce to: ``mma`` with every k-step staged is the product, with
fewer stages the staged steps repeated.
"""

import functools
import types

import numpy as np
import pytest
import torch

from sparsifyme_tpu_torch.bench import units_probe as up
from sparsifyme_tpu_torch.ops.kernels import spmm24_kernel as k3
from sparsifyme_tpu_torch.ops.kernels.prune_kernel import \
    prune_compress_24_plain

TOL = 2e-2


@pytest.fixture
def units(monkeypatch):
    """``experiments/units.py`` with interpreted kernels and a
    ``time_kernel`` that keeps ``(output, operands)`` in ``units.runs``."""
    from jax.experimental import pallas as pl

    monkeypatch.syspath_prepend("experiments")
    import units as mod

    interp = types.SimpleNamespace(**{
        n: getattr(pl, n) for n in dir(pl) if not n.startswith("_")})
    interp.pallas_call = functools.partial(pl.pallas_call, interpret=True)
    runs = []

    def keep(f, args, carrier=0, **kw):
        runs.append((np.array(f(*args).astype(np.float32)),
                     [np.asarray(a) for a in args]))
        return types.SimpleNamespace(ms=0.0)

    monkeypatch.setattr(mod, "pl", interp)
    monkeypatch.setattr(mod, "time_kernel", keep)
    mod.runs = runs
    return mod


def _torch(args):
    """The probe's numpy operands as the port's: bf16 planes and b, uint8
    codes."""
    v0, v1, codes, b = (torch.from_numpy(np.asarray(a, np.float32))
                        for a in args)
    return (v0.to(torch.bfloat16), v1.to(torch.bfloat16),
            codes.to(torch.uint8), b.to(torch.bfloat16))


def _rel(got, want):
    got, want = got.float(), want.float()
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("m,k", [(256, 128), (256, 256), (384, 192)])
def test_fp1_is_the_jax_fp1_probe(units, m, k):
    units.run_probe_fp1(m, 128, k, bm=128)
    out, args = units.runs[-1]
    v0, v1, codes, b = _torch(args)
    got = up.fp1_plain(v0, v1, codes, b)
    want = torch.from_numpy(out)[:m]
    assert _rel(got, want) <= TOL
    a_t = k3.expand_planes(v0, v1, codes).float()
    unpermuted = a_t.T @ b.float()
    assert _rel(unpermuted, want) >= 0.5
    # what the kernel computes: A @ b' on the permuted operand
    kernel_view = k3.spmm24_plain(v0, v1, codes, up.fp1_operand(b),
                                  k_logical=k, out_dtype=torch.bfloat16)
    assert _rel(kernel_view, got) <= TOL


@pytest.mark.parametrize("stages", [4, 2])
@pytest.mark.parametrize("m,k,bm", [(256, 128, 128), (256, 256, 128),
                                    (256, 256, 64)])
def test_feed_is_the_jax_expand_probe(units, m, k, bm, stages):
    units.run_probe(m, 128, k, bm=bm, mode="expand")
    out, args = units.runs[-1]
    v0, v1, codes, b = _torch(args)
    got, side = up.units_plain(v0, v1, codes, b, mode="feed", stages=stages,
                               bm=bm, bn=128)
    assert _rel(got, torch.from_numpy(out)[:m]) <= TOL
    # the probe's codes are all 1, so every block's words cancel in pairs
    assert side.shape == (1, m // bm) and not side.any()


def _planes(rng, m, k):
    a = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32))
    return prune_compress_24_plain(a.to(torch.bfloat16))


@pytest.mark.parametrize("stages", [4, 2])
def test_mma_with_every_step_staged_is_the_product(rng, stages):
    v0, v1, codes = _planes(rng, 96, 64 * stages)
    b = torch.from_numpy(rng.standard_normal((64 * stages, 40))
                         .astype(np.float32)).to(torch.bfloat16)
    got, _ = up.units_plain(v0, v1, codes, b, mode="mma", stages=stages,
                            bm=64, bn=64)
    want = k3.spmm24_plain(v0, v1, codes, b, k_logical=64 * stages,
                           out_dtype=torch.bfloat16)
    assert _rel(got, want) <= TOL


def test_mma_repeats_its_staged_steps(rng):
    """Five k-steps on two stages: slot 0 runs k-steps 0, 2, 4 (three
    times k-step 0's product), slot 1 k-steps 1, 3."""
    v0, v1, codes = _planes(rng, 64, 320)
    b = torch.from_numpy(rng.standard_normal((320, 16)).astype(np.float32))
    b = b.to(torch.bfloat16)
    got, _ = up.units_plain(v0, v1, codes, b, mode="mma", stages=2, bm=64,
                            bn=64)
    a = k3.expand_planes(v0, v1, codes).float().T
    b32 = b.float()
    want = 3 * a[:, :64] @ b32[:64] + 2 * a[:, 64:128] @ b32[64:128]
    assert _rel(got, want.to(torch.bfloat16)) <= TOL


@pytest.mark.parametrize("stages", [4, 2, 1])
def test_full_is_k3_at_every_depth(rng, stages):
    v0, v1, codes = _planes(rng, 72, 147)
    b = torch.from_numpy(rng.standard_normal((147, 24)).astype(np.float32))
    b = b.to(torch.bfloat16)
    got, side = up.units_plain(v0, v1, codes, b, mode="full", stages=stages,
                               bm=64, bn=64)
    want = k3.spmm24_plain(v0, v1, codes, b, k_logical=147,
                           out_dtype=torch.bfloat16)
    assert torch.equal(got, want) and not side.any()


def test_meta_xor_is_the_xor_of_the_tile_words(rng):
    """Per block, the XOR of ``meta_words`` over every k-step, with rows
    past M zero bytes; a block whose codes change changes its word."""
    _, _, codes = _planes(rng, 200, 192)
    words = up.meta_xor(codes, 192, 64)
    assert words.shape == (4,)
    pad = torch.zeros((codes.shape[0], 256), dtype=torch.uint8)
    pad[:, :200] = codes
    for blk in range(4):
        acc = 0
        for kt in range(3):
            es = k3.staged_codes(pad[:, blk * 64:(blk + 1) * 64], 48, False,
                                 kt)
            for w in k3.meta_words(es, 48, False, kt).flatten().tolist():
                acc ^= w
        assert words[blk] == acc
    flipped = codes.clone()
    flipped[5, 70] = 9 if flipped[5, 70] != 9 else 6
    changed = up.meta_xor(flipped, 192, 64) != words
    assert changed.tolist() == [False, True, False, False]


def test_wrappers_refuse_cpu_tensors(rng):
    """The CUDA wrappers launch their kernel or raise: CPU tensors and a
    variant the kernel file does not build are refused."""
    v0, v1, codes = _planes(rng, 64, 64)
    b = torch.from_numpy(rng.standard_normal((64, 16)).astype(np.float32))
    b = b.to(torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        up.units_cuda(v0, v1, codes, b, mode="feed", stages=4)
    with pytest.raises(ValueError, match="CUDA"):
        up.fp1_cuda(v0, v1, codes, b)
    with pytest.raises(ValueError, match="CUDA"):
        up.check(v0, v1, codes, b, ("feed", 4))
    with pytest.raises(ValueError, match="is not one of"):
        up.units_cuda(v0, v1, codes, b, mode="feed", stages=1)
    with pytest.raises(ValueError, match="is not one of"):
        up.units_plain(v0, v1, codes, b, mode="feed", stages=1, bm=64,
                       bn=64)


def test_probe_shapes_and_bounds():
    """The JAX probe's three shapes (b = 32 folded into m), then E and D;
    each time's bound by what bounds it."""
    assert up.SHAPES[:3] == [(3136 * 32, 128, 512), (784 * 32, 256, 1024),
                             (12544 * 32, 64, 576)]
    assert up.SHAPES[3:] == [(12544 * 32, 256, 64), (196 * 32, 512, 4608)]
    b = up.bounds_ms(25088, 256, 1024)
    assert b["feed"][1] == "bytes" and b["mma"][1] == "operations"
    assert b["full"][0] == max(b["feed"][0], b["mma"][0])


def test_check_parent_needs_a_tree_and_a_card(capsys):
    """``bench/check_parent.py`` (K2, K3 and K7 against another checkout's
    build) refuses to run without the other tree's root or without a
    card, and prints its usage."""
    from sparsifyme_tpu_torch.bench import check_parent

    assert check_parent.main([]) == 1
    if not torch.cuda.is_available():
        assert check_parent.main(["."]) == 1
    assert "usage" in capsys.readouterr().err


def test_check_parent_compares_bits():
    """Its outputs compare bit for bit: a -0.0 differs from a 0.0, where
    ``torch.equal`` calls them equal."""
    from sparsifyme_tpu_torch.bench.check_parent import _bits

    for dt in (torch.bfloat16, torch.float32):
        a = torch.tensor([0.0, 1.5], dtype=dt)
        b = torch.tensor([-0.0, 1.5], dtype=dt)
        assert torch.equal(a, b) and not torch.equal(_bits(a), _bits(b))
    codes = torch.tensor([1, 255], dtype=torch.uint8)
    assert _bits(codes) is codes
