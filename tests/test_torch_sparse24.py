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

from sparsifyme_tpu.ops import prune as jprune
from sparsifyme_tpu.ops import sparse24 as js
from sparsifyme_tpu.ops.kernels.prune_kernel import compress_24_pallas
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


def test_spmm_24_rejects_transpose_a_and_fold2():
    q = ts.compress_24(torch.randn(8, 64))
    b = torch.randn(64, 8)
    with pytest.raises(NotImplementedError):
        ts.spmm_24(q, b, transpose_a=True)
    folded = Sparse24(q.values0, q.values1, q.codes, shape=q.shape, fold=2)
    with pytest.raises(NotImplementedError, match="spmm24_fold_pallas"):
        ts.spmm_24(folded, b)
    with pytest.raises(NotImplementedError, match="spmm24_fold_pallas"):
        sparse24_from_numpy(np.zeros((16, 4)), np.zeros((16, 4)),
                            np.zeros((16, 4)), (8, 64), fold=2,
                            device="cpu")


def test_pack_codes_fp_matches_jax(rng):
    codes = rng.choice([1, 2, 3, 6, 7, 11], size=(32, 10)).astype(np.uint8)
    want = np.asarray(js.pack_codes_fp(jnp.asarray(codes)))
    got = tensor_to_numpy(ts.pack_codes_fp(tensor_from_numpy(codes, "cpu")))
    assert np.array_equal(want, got)
