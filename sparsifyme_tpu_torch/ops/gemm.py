"""Batched dense GEMM baselines.

Counterpart of ``sparsifyme_tpu.ops.gemm``: the yardstick every sparse
kernel is measured against. As the JAX package left it to XLA, the port
leaves it to ``torch.matmul`` (cuBLAS on the card); it is not a kernel of
this repository.

Accumulation is f32, as in the JAX op (``preferred_element_type``). On a
CUDA tensor :func:`batched_gemm` turns off TF32 and bf16 reduced-precision
reductions in cuBLAS (``torch.backends.cuda.matmul.allow_tf32`` and
``allow_bf16_reduced_precision_reduction``), because the sparse kernels
accumulate in full f32 and a baseline with reduced-precision reductions
would not be a like-for-like yardstick.
"""

from __future__ import annotations

from typing import Optional

import torch


def _strict_cuda_matmul() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def batched_gemm(
    a: torch.Tensor,
    b: torch.Tensor,
    *,
    transpose_a: bool = False,
    transpose_b: bool = False,
    alpha: float = 1.0,
    beta: float = 0.0,
    c: Optional[torch.Tensor] = None,
    out_dtype=None,
    fold: bool = True,
) -> torch.Tensor:
    """``C = alpha * op(A) @ op(B) + beta * C`` over leading batch dims.

    ``a``: ``(..., m, k)``; ``b``: ``(k, n)`` shared or ``(..., k, n)``
    per batch. ``fold`` stacks a shared-B batch into one tall product
    (``fold=False`` keeps the batched call; the benchmark races both).
    The product runs in the inputs' type with f32 accumulation inside the
    library; the alpha/beta epilogue runs in f32.
    """
    if a.is_cuda:
        _strict_cuda_matmul()
    if transpose_a:
        a = a.transpose(-1, -2)
    if transpose_b:
        b = b.transpose(-1, -2)
    out_dtype = out_dtype or torch.promote_types(a.dtype, b.dtype)
    dtype = torch.promote_types(a.dtype, b.dtype)
    a, b = a.to(dtype), b.to(dtype)
    if fold and b.ndim == 2 and a.ndim > 2:
        lead = a.shape[:-2]
        out = torch.matmul(a.reshape(-1, a.shape[-1]), b).reshape(
            *lead, a.shape[-2], b.shape[-1])
    else:
        out = torch.matmul(a, b)
    if alpha == 1.0 and (c is None or beta == 0.0):
        return out.to(out_dtype)
    out = alpha * out.to(torch.float32)
    if c is not None and beta != 0.0:
        out = out + beta * c.to(torch.float32)
    return out.to(out_dtype)


def gemm_bf16(a, b, **kw):
    """bf16-storage baseline (the ``cublasHgemmBatched`` analog)."""
    return batched_gemm(a.to(torch.bfloat16), b.to(torch.bfloat16),
                        out_dtype=torch.bfloat16, **kw)


def gemm_f32(a, b, **kw):
    """f32 baseline (the ``cublasSgemmBatched`` analog)."""
    return batched_gemm(a.to(torch.float32), b.to(torch.float32),
                        out_dtype=torch.float32, **kw)


def gemm_f64(a, b, **kw):
    """f64 baseline (the ``cublasDgemmBatched`` analog)."""
    return batched_gemm(a.to(torch.float64), b.to(torch.float64),
                        out_dtype=torch.float64, **kw)
