"""Port parity: the dense baseline ``batched_gemm`` against the JAX
package on the CPU (f32 within 1e-5 relative, bf16 within 2e-2)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparsifyme_tpu.ops import gemm as jg
from sparsifyme_tpu_torch.convert import tensor_from_numpy, tensor_to_numpy
from sparsifyme_tpu_torch.ops import gemm as tg


def _both(arr, jdt=jnp.float32):
    x = np.asarray(jnp.asarray(arr, jdt))
    return jnp.asarray(x), tensor_from_numpy(x, "cpu")


def _rel(j, t):
    ref = np.asarray(j, np.float32)
    return np.abs(tensor_to_numpy(t) - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize("fold", [True, False])
@pytest.mark.parametrize("ta,tb", [(False, False), (True, False),
                                   (False, True), (True, True)])
def test_batched_gemm_flags_match_jax(rng, fold, ta, tb):
    a_shape = (3, 20, 12) if ta else (3, 12, 20)
    b_shape = (8, 20) if tb else (20, 8)
    ja, ta_ = _both(rng.normal(size=a_shape))
    jb, tb_ = _both(rng.normal(size=b_shape))
    want = jg.batched_gemm(ja, jb, transpose_a=ta, transpose_b=tb, fold=fold)
    got = tg.batched_gemm(ta_, tb_, transpose_a=ta, transpose_b=tb,
                          fold=fold)
    assert tuple(got.shape) == want.shape
    assert _rel(want, got) < 1e-5


def test_batched_gemm_alpha_beta_and_per_batch_b(rng):
    ja, ta = _both(rng.normal(size=(2, 6, 10)))
    jb, tb = _both(rng.normal(size=(2, 10, 4)))
    jc, tc = _both(rng.normal(size=(2, 6, 4)))
    want = jg.batched_gemm(ja, jb, alpha=0.5, beta=2.0, c=jc)
    got = tg.batched_gemm(ta, tb, alpha=0.5, beta=2.0, c=tc)
    assert _rel(want, got) < 1e-5


def test_gemm_dtype_variants(rng):
    ja, ta = _both(rng.normal(size=(2, 16, 32)))
    jb, tb = _both(rng.normal(size=(32, 8)))
    got = tg.gemm_bf16(ta, tb)
    assert got.dtype == torch.bfloat16
    assert _rel(jg.gemm_bf16(ja, jb), got) < 2e-2
    got = tg.gemm_f32(ta, tb, fold=False)
    assert got.dtype == torch.float32
    assert _rel(jg.gemm_f32(ja, jb, fold=False), got) < 1e-5
    assert tg.gemm_f64(ta, tb).dtype == torch.float64
