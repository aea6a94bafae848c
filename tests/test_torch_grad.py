"""Port parity: the backwards of ``spmm_24``, ``spmm_ell`` and
``spmm_ell_expand`` (their ``torch.autograd.Function``s) and of the sharded
2:4 SpMMs, against ``jax.vjp`` / ``jax.grad`` through the JAX package's
custom VJPs on the same numpy inputs.

JAX runs on the CPU as ``tests/conftest.py`` forces it, its Pallas kernels
interpreted and its sharded paths on the 8-device virtual mesh; the port
runs its plain versions on CPU tensors and its sharded paths on
``["cpu"] * P`` ranks. Gradients agree within 1e-5 relative (max abs error
over max abs reference) in f32, where only the order of the sums differs,
and 2e-2 in bf16, where the two packages also round at other places.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from sparsifyme_tpu.containers import BlockedEll as JEll
from sparsifyme_tpu.containers import Sparse24 as JS24
from sparsifyme_tpu.ops import ell as je
from sparsifyme_tpu.ops import prune as jprune
from sparsifyme_tpu.ops import sparse24 as js
from sparsifyme_tpu.parallel import spmm_sharded as jsh
from sparsifyme_tpu_torch.containers import BlockedEll, Sparse24
from sparsifyme_tpu_torch.convert import tensor_from_numpy, tensor_to_numpy
from sparsifyme_tpu_torch.ops import ell as te
from sparsifyme_tpu_torch.ops import sparse24 as ts
from sparsifyme_tpu_torch.parallel import mesh as tmesh
from sparsifyme_tpu_torch.parallel import spmm_sharded as tsh

DTYPES = [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)]
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


def _leaf(x, tdt=None):
    """A CPU leaf tensor that requires grad, bit for bit ``x``."""
    t = tensor_from_numpy(np.asarray(x), "cpu")
    return (t if tdt is None else t.to(tdt)).requires_grad_(True)


def _rel(j, t):
    ref = np.asarray(j, np.float32)
    got = tensor_to_numpy(t.detach())
    assert got.shape == ref.shape
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30)


def _cast(rng, shape, jdt):
    return np.asarray(jnp.asarray(rng.normal(size=shape), jdt))


def _planes(rng, shape, jdt):
    """JAX compress of a pruned ``shape`` matrix in ``jdt``."""
    return js.compress_24(jprune.prune_24(jnp.asarray(_cast(rng, shape,
                                                             jdt)))[0])


@pytest.mark.parametrize("tout", [False, True])
@pytest.mark.parametrize("epi", [False, True])
@pytest.mark.parametrize("jdt,tdt", DTYPES)
def test_spmm24_grads_match_jax(rng, tout, epi, jdt, tdt):
    b_, m, k, n = 2, 16, 128, 24
    s = _planes(rng, (b_, m, k), jdt)
    jb = jnp.asarray(_cast(rng, (k, n), jdt))
    out_shape = (n, b_ * m) if tout else (b_, m, n)
    g = _cast(rng, out_shape, jdt)
    jc = jnp.asarray(_cast(rng, out_shape, jnp.float32)) if epi else None
    kw = dict(alpha=0.5, beta=-1.5) if epi else {}

    def jf(v0, v1, b, c):
        return js.spmm_24(JS24(v0, v1, s.codes, shape=s.shape), b, c=c,
                          transpose_out=tout, interpret=True, **kw)

    _, vjp = jax.vjp(jf, s.values0, s.values1, jb, jc)
    want = vjp(jnp.asarray(g))
    leaves = [_leaf(s.values0), _leaf(s.values1), _leaf(jb)]
    if epi:
        leaves.append(_leaf(jc))
    codes = tensor_from_numpy(np.asarray(s.codes), "cpu")
    out = ts.spmm_24(Sparse24(leaves[0], leaves[1], codes, shape=s.shape),
                     leaves[2], c=leaves[3] if epi else None,
                     transpose_out=tout, **kw)
    assert out.grad_fn is not None and out.dtype == tdt
    got = torch.autograd.grad(out, leaves, tensor_from_numpy(g, "cpu"))
    for w, h, leaf in zip(want, got, leaves):
        assert h.dtype == leaf.dtype and _rel(w, h) < TOL[tdt]


def test_spmm24_packed_codes_give_the_same_grads(rng):
    s = _planes(rng, (32, 128), jnp.float32)
    codes = tensor_from_numpy(np.asarray(s.codes), "cpu")
    b = rng.normal(size=(128, 8))
    grads = []
    for packed in (False, True):
        leaves = [_leaf(s.values0), _leaf(s.values1), _leaf(b, torch.float32)]
        out = ts.spmm_24(Sparse24(leaves[0], leaves[1], codes,
                                  shape=s.shape), leaves[2],
                         transpose_out=True, packed_codes=packed)
        grads.append(torch.autograd.grad(out.square().sum(), leaves))
    for a, b_ in zip(*grads):
        assert torch.equal(a, b_)


def _ell(rng, shape, bs, ell, bk, jdt):
    e = je.ell_from_dense(jnp.asarray(_cast(rng, shape, jdt)), bs, ell, bk)
    cols = tensor_from_numpy(np.asarray(e.col_indices), "cpu")
    return e, cols


@pytest.mark.parametrize("tout", [False, True])
@pytest.mark.parametrize("epi", [False, True])
@pytest.mark.parametrize("jdt,tdt", DTYPES)
def test_spmm_ell_grads_match_jax(rng, tout, epi, jdt, tdt):
    bs, bk = (128, 32) if tout else (16, 64)
    b_, m, k, n = (1, 128, 256, 16) if bs == 128 else (2, 32, 256, 24)
    e, cols = _ell(rng, (b_, m, k), bs, (k // bk) // 2, bk, jdt)
    jb = jnp.asarray(_cast(rng, (k, n), jdt))
    out_shape = (n, b_ * m) if tout else (b_, m, n)
    g = _cast(rng, out_shape, jdt)
    jc = jnp.asarray(_cast(rng, out_shape, jnp.float32)) if epi else None
    kw = dict(alpha=2.0, beta=0.25) if epi else {}

    def jf(values, b, c):
        return je.spmm_ell(JEll(values=values, col_indices=e.col_indices,
                                shape=e.shape, block_size=bs, block_k=bk),
                           b, c=c, transpose_out=tout, interpret=True, **kw)

    _, vjp = jax.vjp(jf, e.values, jb, jc)
    want = vjp(jnp.asarray(g))
    leaves = [_leaf(e.values), _leaf(jb)] + ([_leaf(jc)] if epi else [])
    f = BlockedEll(values=leaves[0], col_indices=cols, shape=e.shape,
                   block_size=bs, block_k=bk)
    out = te.spmm_ell(f, leaves[1], c=leaves[2] if epi else None,
                      transpose_out=tout, **kw)
    assert out.grad_fn is not None and out.dtype == tdt
    got = torch.autograd.grad(out, leaves, tensor_from_numpy(g, "cpu"))
    for w, h, leaf in zip(want, got, leaves):
        assert h.dtype == leaf.dtype and _rel(w, h) < TOL[tdt]


@pytest.mark.parametrize("tout", [False, True])
@pytest.mark.parametrize("jdt,tdt", DTYPES)
def test_spmm_ell_expand_grads_match_jax(rng, tout, jdt, tdt):
    bs, bk, b_, m, k, n = 128, 32, 1, 256, 192, 24
    e, cols = _ell(rng, (b_, m, k), bs, 3, bk, jdt)
    vkm = je.ell_values_kmajor(e)
    jb = jnp.asarray(_cast(rng, (k, n), jdt))
    g = _cast(rng, (n, b_ * m) if tout else (b_, m, n), jdt)

    def jf(values_km, b):
        return je.spmm_ell_expand(e, b, values_km=values_km,
                                  transpose_out=tout, interpret=True)

    _, vjp = jax.vjp(jf, vkm, jb)
    want = vjp(jnp.asarray(g))
    leaves = [_leaf(vkm), _leaf(jb)]
    f = BlockedEll(values=tensor_from_numpy(np.asarray(e.values), "cpu"),
                   col_indices=cols, shape=e.shape, block_size=bs,
                   block_k=bk)
    out = te.spmm_ell_expand(f, leaves[1], values_km=leaves[0],
                             transpose_out=tout)
    assert out.grad_fn is not None and out.dtype == tdt
    got = torch.autograd.grad(out, leaves, tensor_from_numpy(g, "cpu"))
    for w, h, leaf in zip(want, got, leaves):
        assert h.dtype == leaf.dtype and _rel(w, h) < TOL[tdt]


@pytest.mark.parametrize("tout", [False, True])
def test_spmm_ell_expand_grad_sums_repeated_columns(rng, tout):
    """A block column named twice: the forward multiplies the last slot,
    while the VJP, as JAX writes it, densifies with ``ell_to_dense``, which
    adds the two slots: ``db`` is that of the summed product, in both
    packages."""
    bs = bk = 16
    vals = rng.normal(size=(32, 32)).astype(np.float32)
    jcols = jnp.asarray(np.array([[0, 0], [2, 2]], np.int32))
    b = rng.normal(size=(64, 8)).astype(np.float32)
    g = rng.normal(size=(8, 32) if tout else (32, 8)).astype(np.float32)
    e = JEll(values=jnp.asarray(vals), col_indices=jcols, shape=(32, 64),
             block_size=bs, block_k=bk)

    def jf(values_km, bb):
        return je.spmm_ell_expand(e, bb, values_km=values_km,
                                  transpose_out=tout, interpret=True)

    _, vjp = jax.vjp(jf, jnp.asarray(vals.T), jnp.asarray(b))
    want = vjp(jnp.asarray(g))
    leaves = [_leaf(vals.T.copy()), _leaf(b)]
    f = BlockedEll(values=torch.from_numpy(vals),
                   col_indices=torch.from_numpy(np.array(jcols)),
                   shape=(32, 64), block_size=bs, block_k=bk)
    out = te.spmm_ell_expand(f, leaves[1], values_km=leaves[0],
                             transpose_out=tout)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(g))
    for w, h in zip(want, got):
        assert _rel(w, h) < 1e-5
    gm = g.T if tout else g
    summed = np.asarray(je.ell_to_dense(e))  # both slots of a column added
    assert np.allclose(tensor_to_numpy(got[1]), summed.T @ gm, atol=1e-4)
    last = summed.copy()
    last[:16, :16], last[16:, 32:48] = vals[:16, 16:], vals[16:, 16:]
    assert np.abs(summed.T @ gm - last.T @ gm).max() > 1.0


def _sharded(rng, batch, m, k, n):
    s = _planes(rng, (batch, m, k), jnp.float32)
    jb = jnp.asarray(rng.normal(size=(k, n)).astype(np.float32))
    return s, jb


@pytest.mark.parametrize("route", ["batch", "row", "ring"])
@pytest.mark.parametrize("p", [2, 4])
def test_sharded_grads_match_jax(rng, route, p):
    """``jax.grad`` through the shard_map versions on P virtual devices;
    the port on ``["cpu"] * P`` ranks."""
    s, jb = _sharded(rng, 4, 8, 64, 8)
    g = rng.normal(size=(4, 8, 8)).astype(np.float32)
    jmesh = JMesh(np.array(jax.devices()[:p]), ("model",))
    tm = tmesh.make_mesh((p,), ("model",), devices=["cpu"] * p)
    jfn, tfn = {"batch": (jsh.spmm_24_batch_sharded,
                          tsh.spmm_24_batch_sharded),
                "row": (jsh.spmm_24_row_sharded, tsh.spmm_24_row_sharded),
                "ring": (jsh.spmm_24_ring, tsh.spmm_24_ring)}[route]

    def loss(v0, v1, b):
        out = jfn(JS24(v0, v1, s.codes, shape=s.shape), b, jmesh, "model")
        return jnp.sum(out * g)

    want = jax.grad(loss, argnums=(0, 1, 2))(s.values0, s.values1, jb)
    leaves = [_leaf(s.values0), _leaf(s.values1), _leaf(jb)]
    codes = tensor_from_numpy(np.asarray(s.codes), "cpu")
    out = tfn(Sparse24(leaves[0], leaves[1], codes, shape=s.shape),
              leaves[2], tm, "model")
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, leaves, torch.from_numpy(g))
    for w, h in zip(want, got):
        assert _rel(w, h) < TOL[torch.float32]
