"""Port parity: Blocked-ELL build, densify and SpMM (K4's plain version)
against the JAX package on the CPU (its Pallas kernel interpreted).

Packing and ``col_indices`` must be bit-identical; products agree within
2e-2 relative in bf16 and 1e-5 in f32.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparsifyme_tpu.ops import ell as je
from sparsifyme_tpu_torch.convert import tensor_from_numpy, tensor_to_numpy
from sparsifyme_tpu_torch.ops import ell as te

DTYPES = [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)]
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


def _both(arr, jdt):
    x = np.asarray(jnp.asarray(arr, jdt))
    return jnp.asarray(x), tensor_from_numpy(x, "cpu")


def _eq(j, t):
    return np.array_equal(np.asarray(j, np.float32), tensor_to_numpy(t))


def _rel(j, t):
    ref = np.asarray(j, np.float32)
    return np.abs(tensor_to_numpy(t) - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize("shape,bs,ell,bk", [
    ((2, 32, 128), 16, 2, 32),
    ((256, 192), 128, 3, 32),
    ((3, 16, 64), 16, 1, 64),
])
@pytest.mark.parametrize("jdt,tdt", DTYPES)
def test_ell_from_dense_and_to_dense_match_jax(rng, shape, bs, ell, bk, jdt,
                                               tdt):
    jw, tw = _both(rng.normal(size=shape), jdt)
    e = je.ell_from_dense(jw, bs, ell, bk)
    f = te.ell_from_dense(tw, bs, ell, bk)
    assert f.values.dtype == tdt and f.col_indices.dtype == torch.int32
    assert _eq(e.values, f.values)
    assert np.array_equal(np.asarray(e.col_indices),
                          tensor_to_numpy(f.col_indices))
    assert (f.ell_blocks, f.m_blocks, f.k_blocks, f.bk, f.nnz) == (
        e.ell_blocks, e.m_blocks, e.k_blocks, e.bk, e.nnz)
    assert f.nbytes() == e.nbytes()
    assert _eq(je.ell_to_dense(e), te.ell_to_dense(f))


@pytest.mark.parametrize("bs,bk,tout,epi", [
    (128, 32, False, False),
    (128, 64, True, False),
    (16, 32, False, True),
    (16, 64, True, True),
])
@pytest.mark.parametrize("jdt,tdt", DTYPES)
def test_spmm_ell_matches_jax(rng, bs, bk, tout, epi, jdt, tdt):
    b_, m, k, n = (1, 128, 256, 32) if bs == 128 else (2, 32, 128, 24)
    jw, tw = _both(rng.normal(size=(b_, m, k)), jdt)
    jb, tb = _both(rng.normal(size=(k, n)), jdt)
    ell = (k // bk) // 2
    e = je.ell_from_dense(jw, bs, ell, bk)
    f = te.ell_from_dense(tw, bs, ell, bk)
    jkw = tkw = {}
    if epi:
        c_shape = (n, b_ * m) if tout else (b_, m, n)
        jc, tc = _both(rng.normal(size=c_shape), jnp.float32)
        jkw = dict(alpha=0.5, beta=0.25, c=jc)
        tkw = dict(alpha=0.5, beta=0.25, c=tc)
    want = je.spmm_ell(e, jb, transpose_out=tout, interpret=True, **jkw)
    got = te.spmm_ell(f, tb, transpose_out=tout, **tkw)
    assert got.dtype == tdt and tuple(got.shape) == want.shape
    assert _rel(want, got) < TOL[tdt]
    ref = te.spmm_ell_reference(f, tb, out_dtype=torch.float32)
    if not (tout or epi):
        assert _rel(np.asarray(ref), got) < TOL[tdt]


def test_spmm_ell_transpose_b_and_out_dtype(rng):
    jw, tw = _both(rng.normal(size=(32, 128)), jnp.bfloat16)
    jb, tb = _both(rng.normal(size=(16, 128)), jnp.bfloat16)
    e = je.ell_from_dense(jw, 16, 2, 32)
    f = te.ell_from_dense(tw, 16, 2, 32)
    want = je.spmm_ell(e, jb, transpose_b=True, out_dtype=jnp.float32,
                       interpret=True)
    got = te.spmm_ell(f, tb, transpose_b=True, out_dtype=torch.float32)
    assert got.dtype == torch.float32
    assert _rel(want, got) < 1e-5


def test_spmm_ell_rejects_transpose_a():
    f = te.ell_from_dense(torch.randn(32, 64), 16, 1, 32)
    with pytest.raises(NotImplementedError):
        te.spmm_ell(f, torch.randn(64, 8), transpose_a=True)


@pytest.mark.parametrize("shape,bs,bk", [
    ((1, 128, 256), 128, 32),
    ((2, 32, 128), 16, 64),
    ((1, 256, 192), 128, 32),
])
@pytest.mark.parametrize("tout", [False, True])
@pytest.mark.parametrize("jdt,tdt", DTYPES)
def test_spmm_ell_expand_matches_jax(rng, shape, bs, bk, tout, jdt, tdt):
    """The expand formulation against the JAX op (its Pallas kernel
    interpreted), C and exactly-shaped C^T, with the k-major values built
    by both packages."""
    k, n = shape[-1], 24
    jw, tw = _both(rng.normal(size=shape), jdt)
    jb, tb = _both(rng.normal(size=(k, n)), jdt)
    ell = (k // bk) // 2
    e = je.ell_from_dense(jw, bs, ell, bk)
    f = te.ell_from_dense(tw, bs, ell, bk)
    vkm = te.ell_values_kmajor(f)
    assert _eq(je.ell_values_kmajor(e), vkm)
    want = je.spmm_ell_expand(e, jb, transpose_out=tout, interpret=True)
    got = te.spmm_ell_expand(f, tb, transpose_out=tout, values_km=vkm)
    rows = int(np.prod(shape[:-1]))
    assert tuple(got.shape) == ((n, rows) if tout else shape[:-1] + (n,))
    assert got.dtype == tdt and tuple(got.shape) == want.shape
    assert _rel(want, got) < TOL[tdt]
    gather = te.spmm_ell(f, tb, transpose_out=tout)
    assert _rel(np.asarray(gather.float()), got) < TOL[tdt]


@pytest.mark.parametrize("tout", [False, True])
def test_ell_expand_repeated_column_last_slot_wins(rng, tout):
    """With a block column named twice, the expand kernel multiplies the
    last slot's block (JAX's scatter overwrites); the gather kernel sums."""
    from sparsifyme_tpu.ops.kernels.ell_kernel import (ell_expand_spmm_pallas,
                                                       ell_spmm_pallas)
    from sparsifyme_tpu_torch.ops.kernels import ell_kernel as tk

    vals = rng.normal(size=(32, 32)).astype(np.float32)
    cols = np.array([[0, 0], [2, 2]], np.int32)
    b = rng.normal(size=(64, 8)).astype(np.float32)
    kw = dict(block_size=16, block_k=16, transpose_out=tout)
    want = np.asarray(ell_expand_spmm_pallas(
        jnp.asarray(vals.T), jnp.asarray(cols), jnp.asarray(b),
        out_dtype=jnp.float32, interpret=True, **kw))
    got = tk.ell_expand_spmm_plain(
        torch.from_numpy(vals.T.copy()), torch.from_numpy(cols),
        torch.from_numpy(b), out_dtype=torch.float32, **kw)
    assert np.allclose(tensor_to_numpy(got), want, rtol=1e-5, atol=1e-5)
    rows0 = want.T[:16] if tout else want[:16]  # block-row 0: cols [0, 0]
    assert np.allclose(rows0, vals[:16, 16:] @ b[:16], atol=1e-4)
    summed = np.asarray(ell_spmm_pallas(
        jnp.asarray(vals), jnp.asarray(cols), jnp.asarray(b),
        out_dtype=jnp.float32, interpret=True, **kw))
    assert np.abs(summed - want).max() > 1.0
    assert np.allclose(tensor_to_numpy(tk.ell_spmm_plain(
        torch.from_numpy(vals), torch.from_numpy(cols), torch.from_numpy(b),
        out_dtype=torch.float32, **kw)), summed, rtol=1e-5, atol=1e-5)


def _bench_ell(m, n, k):
    """The harness's ELL launch at a ResNet-50 layer (b=32, 50% blocks):
    (rows, n, ell, block_k)."""
    bk = 32 if k < 512 else (64 if k < 1536 else 128)
    return 32 * m, n, (-(-k // bk)) // 2, bk


PLAN_CASES = [_bench_ell(*s) for s in (
    (12544, 64, 147), (12544, 64, 576), (12544, 256, 64), (3136, 128, 1152),
    (784, 256, 1024), (196, 512, 4608))] + [
    (384, 136, 3, 128), (256, 72, 5, 32), (1024, 512, 18, 128),
    (128, 8, 1, 64), (640, 200, 7, 64)]


@pytest.mark.parametrize("m,n,ell,bk", PLAN_CASES)
def test_ell_plan_walks_every_tile_slot_once(rng, m, n, ell, bk):
    """The Hopper tile's plan (picked, and every width and split count
    forced): its persistent blocks issue each (tile, slot, k-step) exactly
    once, K5's only for live slots; a stage never spans two slots; the
    block fits the card."""
    from sparsifyme_tpu_torch.ops.kernels import ell_kernel as ek

    plans = [ek.ell_plan(m, n, ell, bk, 128)] + [
        ek.ell_plan(m, n, ell, bk, 128, widths=(bn,), split_counts=(s,),
                    cta_counts=(c,))
        for bn in ek.TILE_NS for s in (1, 2, 3, 4) for c in (1, 2)]
    cols = rng.integers(0, 2 * ell, size=(m // 128, ell))
    live = ek.live_slots(torch.from_numpy(cols), 2 * ell)
    for plan in (p for p in plans if p is not None):
        assert bk % plan.bk_step == 0 and plan.bk_step in (32, 64)
        assert 2 <= plan.stages <= ek.MAX_STAGES
        assert plan.ctas * (ek.tile_smem(plan.bn, plan.bk_step, plan.stages)
                            + 1024) <= ek.SMEM_SM
        assert plan.ctas == 1 or plan.bn <= 128
        assert plan.grid == min(plan.units, plan.ctas * ek.H100_SMS)
        for mask in (None, live):
            walk = ek.plan_walk(plan, m, n, ell, bk, 128, mask)
            assert len(walk) == plan.grid
            seen = []
            for block in walk:
                for m0, n0, split, steps in block:
                    assert all(kk + plan.bk_step <= bk for _, kk in steps)
                    seen += [(m0, n0, e, kk) for e, kk in steps]
            want = [(m0, n0, e, kk) for m0 in range(0, m, 128)
                    for n0 in range(0, n, plan.bn) for e in range(ell)
                    if mask is None or mask[m0 // 128, e]
                    for kk in range(0, bk, plan.bk_step)]
            assert sorted(seen) == sorted(want)


def test_ell_plan_refuses_what_the_tile_does_not_take():
    from sparsifyme_tpu_torch.ops.kernels import ell_kernel as ek

    assert ek.ell_plan(256, 64, 2, 32, 128) is not None
    assert ek.ell_plan(256, 64, 2, 32, 64) is None    # block rows of 64
    assert ek.ell_plan(256, 64, 2, 16, 128) is None   # block_k 16
    assert ek.ell_plan(256, 60, 2, 32, 128) is None   # n % 8
    assert ek.ell_plan(256, 64, 0, 32, 128) is None   # no slots
    assert ek.plan_args(None) == (0, 0, 0, 0, 0, 0)
    deep = ek.ell_plan(1024, 512, 18, 128, 128)  # 8 tiles of 128 x 256
    assert deep.splits > 1 and deep.units > 8
