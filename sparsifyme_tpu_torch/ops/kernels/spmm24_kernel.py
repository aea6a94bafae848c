"""Wrappers of kernel K3 (2:4 SpMM), beside their plain PyTorch versions.

K3 ``csrc/spmm24.cu`` replaces
``sparsifyme_tpu/ops/kernels/spmm24_kernel.py:spmm24_pallas``,
``spmm24_pallas_fp`` (the fused alpha/beta/c epilogue and split-half packed
codes) and, through :func:`spmm24_fold_cuda`, ``spmm24_fold_pallas`` (fold=2
planes). On the H100 it is bound by tensor-core operations on wide-n
layers and by device-memory bytes on n=64 layers; the source says how its
design meets that.

Contract: ``C[M, n] = decompress24(v0, v1, codes)[:, :k_logical] @ b`` with
planes ``[k4, M]`` (or split-half packed codes ``[k4/2, M]``), ``b
[k_logical, n]``, f32 accumulation, ``alpha * C + beta * c`` and, with
``transpose_out``, C^T ``[n, M]``. The fold route takes planes ``[2*k4,
M/2]`` and returns row-major C ``[M, n]``. The TPU scheduling knobs (tiles,
``pipeline``, chunking, VMEM budgets) have no counterpart.
"""

from __future__ import annotations

from typing import Optional

import torch

from ... import _build
from .prune_kernel import DTYPE_CODES


def unpack_codes_fp(packed: torch.Tensor, k4: int) -> torch.Tensor:
    """Inverse of ``ops.sparse24.pack_codes_fp``: byte ``j`` holds group
    ``j`` in its low nibble and group ``j + k4/2`` in its high nibble."""
    return torch.cat([packed & 0xF, packed >> 4], dim=-2)[..., :k4, :]


def unfold_planes(p: torch.Tensor, fold: int, k4: int,
                  rows: int) -> torch.Tensor:
    """Standard planes ``[k4, rows]`` from row-folded ones ``[fold*k4,
    rows/fold]``, where plane row ``h*k4 + g`` of column ``j`` belongs to
    original row ``fold*j + h``. A compact-size copy."""
    return p.reshape(fold, k4, rows // fold).permute(1, 2, 0).reshape(
        k4, rows)


def expand_planes(v0: torch.Tensor, v1: torch.Tensor,
                  codes: torch.Tensor) -> torch.Tensor:
    """Dense k-major ``A^T [4*k4, M]`` from planes ``[k4, M]``: row
    ``4g+j`` holds ``v0[g]`` where ``i0 == j`` and ``v1[g]`` where
    ``i1 == j``."""
    k4, m = v0.shape
    c = codes.to(torch.int64)
    j = torch.arange(4, device=v0.device)[None, :, None]
    zero = torch.zeros((), dtype=v0.dtype, device=v0.device)
    dense = (torch.where((c >> 2)[:, None, :] == j, v0[:, None, :], zero)
             + torch.where((c & 3)[:, None, :] == j, v1[:, None, :], zero))
    return dense.reshape(4 * k4, m)


def _epilogue_plain(acc: torch.Tensor, alpha: float, beta: float,
                    c: Optional[torch.Tensor], transpose_out: bool,
                    out_dtype: torch.dtype) -> torch.Tensor:
    """``alpha * acc + beta * c`` in f32, C or C^T, one rounding."""
    if transpose_out:
        acc = acc.T
    if alpha != 1.0:
        acc = acc * alpha
    if c is not None and beta != 0.0:
        acc = acc + beta * c.to(torch.float32)
    return acc.to(out_dtype)


def spmm24_plain(v0, v1, codes, b, *, k_logical: int,
                 out_dtype: torch.dtype, alpha: float = 1.0,
                 beta: float = 0.0, c: Optional[torch.Tensor] = None,
                 transpose_out: bool = False,
                 packed_codes: bool = False) -> torch.Tensor:
    """Plain version of K3: decompress, then an f32 product."""
    if packed_codes:
        codes = unpack_codes_fp(codes, v0.shape[0])
    a_t = expand_planes(v0, v1, codes)[:k_logical].to(torch.float32)
    acc = a_t.T @ b.to(torch.float32)
    return _epilogue_plain(acc, alpha, beta, c, transpose_out, out_dtype)


def spmm24_fold_plain(v0, v1, codes, b, *, k_logical: int,
                      out_dtype: torch.dtype, alpha: float = 1.0,
                      beta: float = 0.0,
                      c: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of the fold route: un-fold the planes, then
    :func:`spmm24_plain`."""
    _check_fold(v0, k_logical)
    k4, rows = v0.shape[0] // 2, 2 * v0.shape[1]
    v0, v1, codes = (unfold_planes(p, 2, k4, rows) for p in (v0, v1, codes))
    return spmm24_plain(v0, v1, codes, b, k_logical=k_logical,
                        out_dtype=out_dtype, alpha=alpha, beta=beta, c=c)


def _check_fold(v0: torch.Tensor, k_logical: int) -> None:
    """The contract of ``spmm24_fold_pallas``, so both packages refuse the
    same calls."""
    fk4 = v0.shape[0]
    if fk4 % 2:
        raise ValueError(f"folded planes need even row count, got {fk4}")
    k4 = fk4 // 2
    if k_logical > 4 * k4:
        raise ValueError(f"k_logical {k_logical} > 4*k4 {4 * k4}")
    if k4 > 256:
        raise ValueError(f"fold=2 requires a single k-step (k4 {k4} <= 256)")


def _launch(v0, v1, codes, b, *, k_logical, out_dtype, alpha, beta, c,
            transpose_out, packed_codes, fold, what) -> torch.Tensor:
    k4, m = v0.shape
    k4 //= fold
    kb, n = b.shape
    if not (v0.is_cuda and b.is_cuda):
        raise ValueError(f"{what} needs CUDA tensors")
    if kb != k_logical or k_logical > 4 * k4:
        raise ValueError(f"b has {kb} rows for k_logical {k_logical} and "
                         f"{k4} groups")
    if v1.shape != v0.shape or codes.dtype != torch.uint8:
        raise ValueError("planes must share a shape and codes be uint8")
    want_codes = ((k4 + 1) // 2, m) if packed_codes else (fold * k4, m)
    if tuple(codes.shape) != want_codes:
        raise ValueError(f"codes {tuple(codes.shape)} != {want_codes}")
    if packed_codes and k4 % 2:
        raise ValueError(f"packed codes need an even group count, got {k4}")
    dtype = torch.promote_types(v0.dtype, b.dtype)
    if dtype not in DTYPE_CODES or out_dtype not in DTYPE_CODES:
        raise TypeError(f"spmm24 kernel takes float32/bfloat16, not "
                        f"{dtype} -> {out_dtype}")
    v0 = v0.to(dtype).contiguous()
    v1 = v1.to(dtype).contiguous()
    b = b.to(dtype).contiguous()
    codes = codes.contiguous()
    out_shape = (n, m) if transpose_out else (fold * m, n)
    c32 = None
    if c is not None and beta != 0.0:
        c32 = c.to(torch.float32).reshape(out_shape).contiguous()
    out = torch.empty(out_shape, dtype=out_dtype, device=v0.device)
    # (v0, v1, codes, b, c, out, M, N, K, K4, alpha, beta, tout, packed,
    #  fold, dtype, out_dtype, stream)
    launch = _build.load("spmm24", "spmm24_launch",
                         "pppppp" "iiii" "ff" "iiiii" "p")
    _build.check(launch(
        v0.data_ptr(), v1.data_ptr(), codes.data_ptr(), b.data_ptr(),
        _build.ptr(c32), out.data_ptr(), m, n, k_logical, k4, float(alpha),
        float(beta) if c32 is not None else 0.0, int(transpose_out),
        int(packed_codes), fold, DTYPE_CODES[dtype], DTYPE_CODES[out_dtype],
        _build.stream_ptr(v0)), what)
    return out


def spmm24_cuda(v0, v1, codes, b, *, k_logical: int,
                out_dtype: torch.dtype, alpha: float = 1.0,
                beta: float = 0.0, c: Optional[torch.Tensor] = None,
                transpose_out: bool = False,
                packed_codes: bool = False) -> torch.Tensor:
    """Launch K3. Planes and ``b`` are brought to their promoted type (the
    kernel multiplies like types); ``c`` goes to the kernel as f32."""
    out = _launch(v0, v1, codes, b, k_logical=k_logical, out_dtype=out_dtype,
                  alpha=alpha, beta=beta, c=c, transpose_out=transpose_out,
                  packed_codes=packed_codes, fold=1, what="spmm24_cuda")
    spmm24_cuda.launches += 1
    return out


spmm24_cuda.launches = 0


def spmm24_fold_cuda(v0, v1, codes, b, *, k_logical: int,
                     out_dtype: torch.dtype, alpha: float = 1.0,
                     beta: float = 0.0,
                     c: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch K3 on fold=2 planes ``[2*k4, M/2]``; returns row-major
    ``C [M, n]``."""
    _check_fold(v0, k_logical)
    out = _launch(v0, v1, codes, b, k_logical=k_logical, out_dtype=out_dtype,
                  alpha=alpha, beta=beta, c=c, transpose_out=False,
                  packed_codes=False, fold=2, what="spmm24_fold_cuda")
    spmm24_fold_cuda.launches += 1
    return out


spmm24_fold_cuda.launches = 0
