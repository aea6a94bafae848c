"""Port parity: 2:4 compress (K2's plain version), decompress and SpMM
(K3's plain version) against the JAX package on the CPU.

Compress planes and codes must be bit-identical, padded groups included.
Products agree within 2e-2 relative in bf16 and 1e-5 in f32 (relative to
the largest reference magnitude; both accumulate in f32, in different
orders).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparsifyme_tpu.containers import Sparse24 as JSparse24
from sparsifyme_tpu.ops import prune as jprune
from sparsifyme_tpu.ops import sparse24 as js
from sparsifyme_tpu.ops.kernels.prune_kernel import (
    compress_24_pallas, prune_compress_24_pallas)
from sparsifyme_tpu.ops.kernels.spmm24_kernel import spmm24_fold_pallas
from sparsifyme_tpu_torch.containers import Sparse24
from sparsifyme_tpu_torch.convert import (sparse24_from_numpy,
                                          tensor_from_numpy, tensor_to_numpy)
from sparsifyme_tpu_torch.ops import prune as tprune
from sparsifyme_tpu_torch.ops import sparse24 as ts

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


@pytest.mark.parametrize("shape", [(2, 24, 147), (64, 256), (3, 10, 64)])
@pytest.mark.parametrize("jdt,tdt", DTYPES)
def test_compress_matches_jax(rng, shape, jdt, tdt):
    jw, tw = _both(rng.normal(size=shape), jdt)
    jp, tp = jprune.prune_nm(jw, 2, 4)[0], tprune.prune_nm(tw, 2, 4)[0]
    s = js.compress_24(jp)
    q = ts.compress_24(tp)
    k = shape[-1]
    wt = jnp.swapaxes(jnp.pad(jp.reshape(-1, k), ((0, 0), (0, (-k) % 64))),
                      0, 1)
    g0, g1, gc = compress_24_pallas(wt, interpret=True)
    assert q.shape == tuple(shape) and q.values0.dtype == tdt
    assert tuple(q.values0.shape) == s.values0.shape
    assert q.k4 % 16 == 0 and q.nnz == s.nnz and q.nbytes() == s.nbytes()
    for want in ((s.values0, s.values1, s.codes), (g0, g1, gc)):
        assert _eq(want[0], q.values0)
        assert _eq(want[1], q.values1)
        assert _eq(want[2], q.codes)


def test_compress_padded_groups_keep_positions_2_and_3(rng):
    q = ts.compress_24(torch.randn(5, 147))
    codes = tensor_to_numpy(q.codes)
    assert codes.shape == (48, 5)
    assert (codes[37:] == 11).all()  # groups past k=147 are all-zero
    assert (tensor_to_numpy(q.values0)[37:] == 0).all()


@pytest.mark.parametrize("jdt,tdt", DTYPES)
def test_decompress_round_trip(rng, jdt, tdt):
    _, tw = _both(rng.normal(size=(2, 12, 147)), jdt)
    pw = tprune.prune_nm(tw, 2, 4)[0]
    assert torch.equal(ts.decompress_24(ts.compress_24(pw)), pw)


CASES = [
    # transpose_out, pipeline (JAX side), packed_codes, epilogue
    (False, False, False, False),
    (True, False, False, False),
    (False, False, False, True),
    (True, True, False, True),
    (False, True, True, False),
    (True, True, True, False),
]


@pytest.mark.parametrize("tout,pipeline,packed,epi", CASES)
@pytest.mark.parametrize("jdt,tdt", DTYPES)
def test_spmm_24_matches_jax(rng, tout, pipeline, packed, epi, jdt, tdt):
    b_, m, k, n = 2, 24, 147, 40
    jw, tw = _both(rng.normal(size=(b_, m, k)), jdt)
    jb, tb = _both(rng.normal(size=(k, n)), jdt)
    s = js.compress_24(jprune.prune_nm(jw, 2, 4)[0])
    q = ts.compress_24(tprune.prune_nm(tw, 2, 4)[0])
    kw = {}
    if epi:
        c_shape = (n, b_ * m) if tout else (b_, m, n)
        jc, tc = _both(rng.normal(size=c_shape), jnp.float32)
        kw = dict(alpha=0.5, beta=0.25)
        jkw, tkw = dict(kw, c=jc), dict(kw, c=tc)
    else:
        jkw = tkw = {}
    want = js.spmm_24(s, jb, transpose_out=tout, pipeline=pipeline,
                      packed_codes=packed, **jkw)
    got = ts.spmm_24(q, tb, transpose_out=tout, packed_codes=packed, **tkw)
    assert got.dtype == tdt
    assert tuple(got.shape) == want.shape
    assert _rel(want, got) < TOL[tdt]


def test_spmm_24_out_dtype_and_transpose_b(rng):
    jw, tw = _both(rng.normal(size=(16, 64)), jnp.bfloat16)
    jb, tb = _both(rng.normal(size=(24, 64)), jnp.bfloat16)
    s = js.compress_24(jprune.prune_nm(jw, 2, 4)[0])
    q = ts.compress_24(tprune.prune_nm(tw, 2, 4)[0])
    want = js.spmm_24(s, jb, transpose_b=True, out_dtype=jnp.float32)
    got = ts.spmm_24(q, tb, transpose_b=True, out_dtype=torch.float32)
    assert got.dtype == torch.float32
    assert _rel(want, got) < 1e-5
    ref = ts.spmm_24_reference(q, tb.T, out_dtype=torch.float32)
    assert torch.allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_spmm_24_rejects_transpose_a_and_fold2(rng):
    """transpose_a is refused; a fold=2 operand runs (row-major C only) and
    converts from numpy."""
    w = rng.normal(size=(8, 64)).astype(np.float32)
    q = ts.compress_24(torch.from_numpy(w))
    b = torch.randn(64, 8)
    with pytest.raises(NotImplementedError):
        ts.spmm_24(q, b, transpose_a=True)
    folded = ts.prune_compress_24(torch.from_numpy(w), fold=2)
    assert folded.fold == 2 and folded.k4 == q.k4
    assert torch.allclose(ts.spmm_24(folded, b), ts.spmm_24(q, b),
                          rtol=1e-5, atol=1e-5)
    with pytest.raises(NotImplementedError, match="transpose_out"):
        ts.spmm_24(folded, b, transpose_out=True)
    back = sparse24_from_numpy(*(tensor_to_numpy(p) for p in (
        folded.values0, folded.values1, folded.codes)), folded.shape,
        fold=2, device="cpu")
    assert back.fold == 2 and torch.equal(back.codes, folded.codes)


def _ties(rng, shape, ties):
    x = rng.normal(size=shape)
    return np.round(x * 2) / 2 if ties else x  # many equal magnitudes


def _fold_view(x, k):
    """The [rows/2, 2*kp] view the fold=2 route compresses."""
    kp = -(-k // 64) * 64
    w2 = jnp.pad(x.reshape(-1, k), ((0, 0), (0, kp - k)))
    return w2.reshape(-1, 2 * kp)


@pytest.mark.parametrize("shape", [(2, 12, 147), (16, 64), (3, 4, 256)])
@pytest.mark.parametrize("jdt,tdt", DTYPES)
@pytest.mark.parametrize("fold", [1, 2])
@pytest.mark.parametrize("ties", [False, True])
def test_prune_compress_24_matches_jax(rng, shape, jdt, tdt, fold, ties):
    """Bit-identical to the JAX op and to its Pallas kernel (interpreted),
    for both layouts, and equal to compress_24(prune_nm(w))."""
    jw, tw = _both(_ties(rng, shape, ties), jdt)
    s = js.prune_compress_24(jw, fold=fold)
    q = ts.prune_compress_24(tw, fold=fold)
    k = shape[-1]
    view = _fold_view(jw, k) if fold == 2 else jw
    g = prune_compress_24_pallas(view, interpret=True)
    assert (q.fold, q.shape, q.values0.dtype) == (fold, tuple(shape), tdt)
    assert tuple(q.values0.shape) == s.values0.shape
    for want in ((s.values0, s.values1, s.codes), g):
        assert _eq(want[0], q.values0)
        assert _eq(want[1], q.values1)
        assert _eq(want[2], q.codes)
    if fold == 1:
        p = ts.compress_24(tprune.prune_nm(tw, 2, 4)[0])
        assert all(torch.equal(x, y) for x, y in zip(
            (p.values0, p.values1, p.codes), (q.values0, q.values1, q.codes)))


def test_prune_compress_24_ignores_tpu_knobs(rng):
    w = torch.from_numpy(rng.normal(size=(16, 64)).astype(np.float32))
    q = ts.prune_compress_24(w)
    for kw in (dict(rank_mxu=True), dict(block_rows=256, block_k=128),
               dict(pad128=False, pack_rank=True), dict(fold_rows=True)):
        r = ts.prune_compress_24(w, **kw)
        assert r.fold == 1 and torch.equal(r.codes, q.codes)
        assert torch.equal(r.values0, q.values0)


def test_fold2_plane_order_across_the_seam():
    """k=147 pads each row to kp=192 before the fold: row 2j lives in plane
    rows [0, k4) of column j, row 2j+1 in [k4, 2*k4); padded groups carry
    code 11 and zero values."""
    w = torch.arange(1, 4 * 147 + 1, dtype=torch.float32).reshape(4, 147)
    f = ts.prune_compress_24(w, fold=2)
    u = ts.prune_compress_24(w)
    assert tuple(f.values0.shape) == (96, 2) and f.k4 == 48
    for h in (0, 1):
        for p, r in ((f.values0, u.values0), (f.codes, u.codes)):
            assert torch.equal(p[h * 48:(h + 1) * 48], r[:, h::2])
    assert (f.codes[37:48] == 11).all() and (f.values0[85:96] == 0).all()
    assert torch.equal(ts.decompress_24(f), ts.decompress_24(u))


@pytest.mark.parametrize("shape", [(2, 12, 147), (16, 64)])
@pytest.mark.parametrize("jdt,tdt", DTYPES)
def test_decompress_fold2_matches_jax(rng, shape, jdt, tdt):
    jw, tw = _both(rng.normal(size=shape), jdt)
    got = ts.decompress_24(ts.prune_compress_24(tw, fold=2))
    assert got.dtype == tdt
    assert _eq(js.decompress_24(js.prune_compress_24(jw, fold=2)), got)


@pytest.mark.parametrize("k", [64, 147, 256])
@pytest.mark.parametrize("epi", [False, True])
@pytest.mark.parametrize("jdt,tdt", DTYPES)
def test_spmm_24_fold2_matches_jax(rng, k, epi, jdt, tdt):
    """The fold route against spmm24_fold_pallas (interpreted) and the JAX
    spmm_24 on the same fold=2 operand."""
    b_, m, n = 2, 12, 24
    jw, tw = _both(rng.normal(size=(b_, m, k)), jdt)
    jb, tb = _both(rng.normal(size=(k, n)), jdt)
    s = js.prune_compress_24(jw, fold=2)
    q = ts.prune_compress_24(tw, fold=2)
    kern = spmm24_fold_pallas(s.values0, s.values1, s.codes, jb,
                              k_logical=k, out_dtype=jdt, interpret=True)
    got = ts.spmm_24(q, tb)
    assert got.dtype == tdt and tuple(got.shape) == (b_, m, n)
    assert _rel(kern.reshape(b_, m, n), got) < TOL[tdt]
    jkw = tkw = {}
    if epi:
        jc, tc = _both(rng.normal(size=(b_, m, n)), jnp.float32)
        jkw, tkw = dict(alpha=0.5, beta=0.25, c=jc), dict(alpha=0.5,
                                                         beta=0.25, c=tc)
    want = js.spmm_24(s, jb, **jkw)
    got = ts.spmm_24(q, tb, **tkw)
    assert tuple(got.shape) == want.shape
    assert _rel(want, got) < TOL[tdt]


def _raises_both(exc, jfn, tfn, match=None):
    with pytest.raises(exc, match=match):
        jfn()
    with pytest.raises(exc, match=match):
        tfn()


def test_fold2_refusals_match_jax(rng):
    w = rng.normal(size=(6, 1088)).astype(np.float32)
    jw, tw = jnp.asarray(w), torch.from_numpy(w)
    _raises_both(ValueError, lambda: js.prune_compress_24(jw, fold=3),
                 lambda: ts.prune_compress_24(tw, fold=3), "fold 3")
    _raises_both(ValueError, lambda: js.prune_compress_24(jw[:5], fold=2),
                 lambda: ts.prune_compress_24(tw[:5], fold=2), "rows 5")
    s, q = js.prune_compress_24(jw, fold=2), ts.prune_compress_24(tw, fold=2)
    jb, tb = jnp.zeros((1088, 8)), torch.zeros(1088, 8)
    _raises_both(ValueError, lambda: js.spmm_24(s, jb),
                 lambda: ts.spmm_24(q, tb), "k4 272 <= 256")
    s, q = js.prune_compress_24(jw[:, :64], fold=2), ts.prune_compress_24(
        tw[:, :64], fold=2)
    _raises_both(NotImplementedError,
                 lambda: js.spmm_24(s, jb[:64], transpose_out=True),
                 lambda: ts.spmm_24(q, tb[:64], transpose_out=True))
    odd = JSparse24(s.values0[:31], s.values1[:31], s.codes[:31],
                      shape=(6, 64), fold=2)
    todd = Sparse24(q.values0[:31], q.values1[:31], q.codes[:31],
                    shape=(6, 64), fold=2)
    _raises_both(ValueError, lambda: js.spmm_24(odd, jb[:64]),
                 lambda: ts.spmm_24(todd, tb[:64]), "even row count")


def test_pack_codes_fp_matches_jax(rng):
    codes = rng.choice([1, 2, 3, 6, 7, 11], size=(32, 10)).astype(np.uint8)
    want = np.asarray(js.pack_codes_fp(jnp.asarray(codes)))
    got = tensor_to_numpy(ts.pack_codes_fp(tensor_from_numpy(codes, "cpu")))
    assert np.array_equal(want, got)
