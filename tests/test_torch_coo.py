"""Port parity: the COO container and ops, the block-row packer and K6's
plain version against the JAX package.

The same numpy inputs go through the JAX package (on the CPU; its
segmented kernel interpreted, as ``tests/test_coo.py`` runs it) and
through ``sparsifyme_tpu_torch`` on the CPU. Building, packing and the ELL
conversion are exact and must be bit-identical; products agree within the
JAX tests' own tolerances.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sparsifyme_tpu_torch as sp
from sparsifyme_tpu import containers as jc
from sparsifyme_tpu.ops import coo as jcoo
from sparsifyme_tpu.ops import ell as jell
from sparsifyme_tpu.ops import prune as jprune
from sparsifyme_tpu.ops.kernels import coo_kernel as jkern
from sparsifyme_tpu_torch import convert
from sparsifyme_tpu_torch.ops import coo as tcoo
from sparsifyme_tpu_torch.ops import ell as tell
from sparsifyme_tpu_torch.ops import prune as tprune
from sparsifyme_tpu_torch.ops.kernels import coo_kernel as tkern


def _sparse(rng, m, k, density=0.1):
    w = rng.normal(size=(m, k)).astype(np.float32)
    return w * (rng.random((m, k)) < density)


def _port(a):
    """A JAX Coo as the port's, through numpy."""
    return convert.coo_from_numpy(np.asarray(a.rows), np.asarray(a.cols),
                                  np.asarray(a.values), a.shape,
                                  device="cpu")


def _np(t):
    return convert.tensor_to_numpy(t)


def _same(j, t):
    assert np.asarray(j).dtype == _np(t).dtype
    assert np.array_equal(np.asarray(j), _np(t))


@pytest.mark.parametrize("pad", [None, 7])
def test_coo_from_dense_matches_jax(rng, pad):
    w = _sparse(rng, 32, 48, 0.2)
    nnz = None if pad is None else int((w != 0).sum()) + pad
    j = jcoo.coo_from_dense(w, nnz=nnz)
    for t in (tcoo.coo_from_dense(w, nnz=nnz, device="cpu"),
              tcoo.coo_from_dense(torch.from_numpy(w), nnz=nnz)):
        assert t.shape == j.shape and t.nnz == j.nnz
        assert t.rows.dtype == t.cols.dtype == torch.int32
        _same(j.rows, t.rows)
        _same(j.cols, t.cols)
        _same(j.values, t.values)
        assert np.array_equal(_np(t.todense()), w)
    with pytest.raises(ValueError, match="nnz"):
        tcoo.coo_from_dense(w, nnz=3, device="cpu")


def test_coo_todense_sums_duplicates_as_jax():
    rows, cols = np.array([0, 0, 5, 5, 2]), np.array([1, 1, 2, 2, 7])
    vals = np.array([1.0, 2.0, 3.0, 4.0, -1.5], np.float32)
    j = jc.Coo(rows=jnp.asarray(rows, jnp.int32),
               cols=jnp.asarray(cols, jnp.int32), values=jnp.asarray(vals),
               shape=(8, 8))
    t = convert.coo_from_numpy(rows, cols, vals, (8, 8), device="cpu")
    assert isinstance(t, sp.Coo) and t.dtype == torch.float32
    assert np.array_equal(np.asarray(j.todense()), _np(sp.coo_to_dense(t)))
    assert _np(t.todense())[0, 1] == 3.0


@pytest.mark.parametrize("jdt", [jnp.float32, jnp.bfloat16])
def test_coo_converters_round_trip(rng, jdt):
    j = jcoo.coo_from_dense(np.asarray(jnp.asarray(_sparse(rng, 16, 24, 0.3),
                                                   jdt)), nnz=160)
    t = _port(j)
    rows, cols, vals, shape = convert.coo_to_numpy(t)
    assert shape == j.shape
    assert np.array_equal(rows, np.asarray(j.rows))
    assert np.array_equal(cols, np.asarray(j.cols))
    assert np.array_equal(vals, np.asarray(j.values, np.float32))


@pytest.mark.parametrize("m,k,density,block_rows", [
    (256, 384, 0.5, 128), (200, 130, 0.1, 128), (37, 64, 0.3, 16),
    (300, 40, 0.02, 48)])
def test_pack_coo_bit_identical(rng, m, k, density, block_rows):
    a = jcoo.coo_from_dense(_sparse(rng, m, k, density), nnz=None)
    for j, t in zip(jcoo.pack_coo(a, block_rows),
                    tcoo.pack_coo(_port(a), block_rows)):
        _same(j, t)


def test_packer_keeps_entry_order_within_a_block_row(rng):
    """Shuffled entries with repeated coordinates: the stable sort keeps
    each block-row's entries in input order, as the numpy packer does."""
    n = 500
    rows = rng.integers(0, 300, n)
    cols = rng.integers(0, 40, n)
    rows[:20], cols[:20] = 7, 3
    vals = rng.normal(size=n).astype(np.float32)
    want = jkern.pack_coo_blockrows(rows, cols, vals, 300, block_rows=64)
    got = tkern.pack_coo_blockrows(torch.from_numpy(rows),
                                   torch.from_numpy(cols),
                                   torch.from_numpy(vals), 300,
                                   block_rows=64)
    for j, t in zip(want, got):
        _same(j, t)


@pytest.mark.parametrize("batch_chunk", [None, 2, 4])
@pytest.mark.parametrize("jdt", [jnp.float32, jnp.bfloat16])
def test_spmm_coo_matches_jax(rng, batch_chunk, jdt):
    a = rng.normal(size=(100, 64)).astype(np.float32)
    a[np.abs(a) < 0.7] = 0
    j = jcoo.coo_from_dense(a, nnz=4096)
    b = np.asarray(jnp.asarray(rng.normal(size=(8, 64, 32)), jdt))
    want = np.asarray(jcoo.spmm_coo(j, jnp.asarray(b), out_dtype=jnp.float32,
                                    batch_chunk=batch_chunk))
    got = tcoo.spmm_coo(_port(j), convert.tensor_from_numpy(b, "cpu"),
                        out_dtype=torch.float32, batch_chunk=batch_chunk)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), want, rtol=1e-5, atol=1e-5)


def test_spmm_coo_unbatched_and_dtypes(rng):
    w = _sparse(rng, 32, 64)
    j = jcoo.coo_from_dense(w)
    b = rng.normal(size=(64, 24)).astype(np.float32)
    want = jcoo.spmm_coo(j, jnp.asarray(b))
    got = tcoo.spmm_coo(_port(j), torch.from_numpy(b))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    got16 = tcoo.spmm_coo(_port(j), torch.from_numpy(b).to(torch.bfloat16),
                          out_dtype=torch.bfloat16)
    assert got16.dtype == torch.bfloat16
    with pytest.raises(ValueError, match="batch_chunk"):
        tcoo.spmm_coo(_port(j), torch.zeros(6, 64, 8), batch_chunk=4)
    with pytest.raises(ValueError, match="rows"):
        tcoo.spmm_coo(_port(j), torch.zeros(63, 8))


@pytest.mark.parametrize("density", [0.5, 0.3, 0.1])
@pytest.mark.parametrize("shape", [(256, 384, 96), (200, 130, 64),
                                   (128, 128, 128)])
def test_spmm_coo_segmented_matches_jax_kernel(rng, density, shape):
    m, k, n = shape
    j = jcoo.coo_from_dense(_sparse(rng, m, k, density))
    b = rng.normal(size=(k, n)).astype(np.float32)
    want = np.asarray(jcoo.spmm_coo_segmented(j, jnp.asarray(b),
                                              out_dtype=jnp.float32))
    got = tcoo.spmm_coo_segmented(_port(j), torch.from_numpy(b),
                                  out_dtype=torch.float32)
    np.testing.assert_allclose(_np(got), want, rtol=1e-5, atol=1e-4)


def test_spmm_coo_segmented_batched_shared_a(rng):
    j = jcoo.coo_from_dense(_sparse(rng, 128, 96, 0.2))
    b = rng.normal(size=(4, 96, 48)).astype(np.float32)
    want = np.asarray(jcoo.spmm_coo_segmented(j, jnp.asarray(b),
                                              out_dtype=jnp.float32))
    t = _port(j)
    packed = tcoo.pack_coo(t)
    for gather in tcoo.GATHERS:
        got = tcoo.spmm_coo_segmented(t, torch.from_numpy(b), packed=packed,
                                      gather=gather)
        assert tuple(got.shape) == (4, 128, 48)
        np.testing.assert_allclose(_np(got), want, rtol=1e-5, atol=1e-4)
    with pytest.raises(ValueError, match="gather"):
        tcoo.spmm_coo_segmented(t, torch.from_numpy(b), gather="onehot")


def test_spmm_coo_segmented_sums_duplicates():
    i32 = dict(dtype=torch.int32)
    a = sp.Coo(rows=torch.tensor([0, 0, 5, 5], **i32),
               cols=torch.tensor([1, 1, 2, 2], **i32),
               values=torch.tensor([1.0, 2.0, 3.0, 4.0]), shape=(8, 8))
    got = _np(tcoo.spmm_coo_segmented(a, torch.eye(8)))
    assert got[0, 1] == 3.0 and got[5, 2] == 7.0 and got.sum() == 10.0


@pytest.mark.parametrize("block_rows", [128, 16])
def test_plain_kernel_version_matches_jax_pallas(rng, block_rows):
    """K6's plain version on JAX-packed planes against the TPU kernel,
    interpreted, on B with the batch folded into its columns."""
    m, k, n, batch = 200, 130, 24, 3
    j = jcoo.coo_from_dense(_sparse(rng, m, k, 0.2))
    planes = jcoo.pack_coo(j, block_rows)
    b = rng.normal(size=(batch, k, n)).astype(np.float32)
    b2 = np.moveaxis(b, 0, 1).reshape(k, batch * n)
    want = np.asarray(jkern.spmm_coo_pallas(*planes, jnp.asarray(b2), m=m,
                                            block_rows=block_rows,
                                            interpret=True))
    got = tkern.spmm_coo_plain(*(torch.from_numpy(np.array(p))
                                 for p in planes), torch.from_numpy(b), m=m,
                               block_rows=block_rows)
    got2 = np.moveaxis(_np(got), 0, 1).reshape(m, batch * n)
    np.testing.assert_allclose(got2, want, rtol=1e-5, atol=1e-4)


def test_coo_to_ell_bit_identical(rng):
    w = _sparse(rng, 32, 64, 0.1)
    w[8:16] = 0  # an empty block-row: every slot is padding
    j = jcoo.coo_from_dense(w, nnz=int((w != 0).sum()) + 5)
    e, f = jcoo.coo_to_ell(j, block_size=8), tcoo.coo_to_ell(_port(j), 8)
    assert (f.shape, f.block_size, f.block_k) == (e.shape, e.block_size, 0)
    _same(e.col_indices, f.col_indices)
    _same(e.values, f.values)
    assert (_np(f.col_indices)[1] == 0).all()
    e4 = jcoo.coo_to_ell(j, block_size=8, ell_blocks=8)
    _same(e4.col_indices, tcoo.coo_to_ell(_port(j), 8, 8).col_indices)
    with pytest.raises(ValueError, match="ell_blocks"):
        tcoo.coo_to_ell(_port(j), 8, 1)
    with pytest.raises(ValueError, match="divisible"):
        tcoo.coo_to_ell(_port(j), 12)


def test_coo_to_ell_then_expand_is_wrong_in_both_packages(rng):
    """``coo_to_ell`` pads block-row 0's unused slot with block column 0,
    so the column repeats. The expand formulation keeps the last slot
    (the zero padding) in both packages and misses block-row 0's product;
    the gather formulation sums the slots and is exact."""
    w = rng.normal(size=(32, 32)).astype(np.float32)
    w[:16, 16:] = 0
    b = rng.normal(size=(32, 24)).astype(np.float32)
    dense = w.astype(np.float64) @ b
    j = jcoo.coo_from_dense(w)
    e, f = jcoo.coo_to_ell(j, block_size=16), tcoo.coo_to_ell(_port(j), 16)
    assert _np(f.col_indices).tolist() == [[0, 0], [0, 1]]
    jx = np.asarray(jell.spmm_ell_expand(e, jnp.asarray(b),
                                         out_dtype=jnp.float32,
                                         interpret=True))
    tx = _np(tell.spmm_ell_expand(f, torch.from_numpy(b)))
    np.testing.assert_allclose(tx, jx, rtol=1e-5, atol=1e-4)
    assert np.abs(tx - dense).max() > 1.0
    assert np.abs(tx[:16]).max() == 0.0 and np.allclose(tx[16:], dense[16:],
                                                        atol=1e-4)
    tg = _np(tell.spmm_ell(f, torch.from_numpy(b)))
    np.testing.assert_allclose(tg, dense, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(
        np.asarray(jell.spmm_ell(e, jnp.asarray(b), interpret=True)), tg,
        rtol=1e-5, atol=1e-4)


def test_coo_slice_end_to_end_matches_jax(rng):
    """Threshold prune -> COO -> oracle, K6's plain version and the ELL
    conversion, in both packages on one seeded input."""
    a = rng.normal(size=(96, 64)).astype(np.float32)
    b = rng.normal(size=(4, 64, 16)).astype(np.float32)
    jp, _ = jprune.prune_threshold(jnp.asarray(a), threshold=1.0)
    tp, _ = tprune.prune_threshold(torch.from_numpy(a), 1.0)
    assert np.array_equal(np.asarray(jp), _np(tp))
    nnz = int(np.count_nonzero(np.asarray(jp))) + 9
    j = jcoo.coo_from_dense(np.asarray(jp), nnz=nnz)
    t = tcoo.coo_from_dense(tp, nnz=nnz)
    _same(j.rows, t.rows)
    jb, tb = jnp.asarray(b), torch.from_numpy(b)
    for jf, tf in ((jcoo.spmm_coo, tcoo.spmm_coo),
                   (jcoo.spmm_coo_segmented, tcoo.spmm_coo_segmented)):
        np.testing.assert_allclose(_np(tf(t, tb)), np.asarray(jf(j, jb)),
                                   rtol=1e-5, atol=1e-4)
    e, f = jcoo.coo_to_ell(j, 32), tcoo.coo_to_ell(t, 32)
    _same(e.values, f.values)
    np.testing.assert_allclose(
        _np(tell.spmm_ell(f, tb[0])),
        np.asarray(jell.spmm_ell(e, jb[0], interpret=True)), rtol=1e-5,
        atol=1e-4)
