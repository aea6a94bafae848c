"""2:4 structured sparsity: compress, decompress and SpMM entry points.

Counterpart of ``sparsifyme_tpu.ops.sparse24`` (the prune -> compress ->
matmul pipeline of the reference's cusparseLt spmma). :func:`compress_24`
and :func:`prune_compress_24` run kernel K2 and :func:`spmm_24` kernel K3
on CUDA tensors, and their plain versions on CPU tensors. :func:`spmm_24` on
fold=1 operands is differentiable in the planes, ``b`` and ``c`` through the
JAX package's VJP, on either device; the fold=2 route has no VJP there and
raises on the card under grad.

Compressed layout (see :class:`~sparsifyme_tpu_torch.containers.Sparse24`):
k-major, batch-folded planes ``[k4, M]``, k padded to a multiple of 64, or
row-folded ``[2*k4, M/2]`` (``fold=2``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .. import _build
from ..containers import Sparse24
from .kernels.prune_kernel import (compress_24_cuda, compress_24_plain,
                                   prune_compress_24_cuda,
                                   prune_compress_24_plain)
from .kernels.spmm24_kernel import (expand_planes, spmm24_cuda,
                                    spmm24_fold_cuda, spmm24_fold_plain,
                                    spmm24_plain, unfold_planes)


def compress_24(w: torch.Tensor) -> Sparse24:
    """Compress a (2:4-pruned) matrix ``(..., m, k)`` into
    :class:`Sparse24`. The two largest-magnitude elements of every group of
    4 are kept (ties to the later position, as in
    :func:`~.prune.prune_nm`), so an exactly 2:4 input keeps precisely its
    nonzeros."""
    k = w.shape[-1]
    w2 = w.reshape(-1, k)
    if _build.use_kernel(w):
        v0, v1, codes = compress_24_cuda(w2)
    else:
        v0, v1, codes = compress_24_plain(w2)
    return Sparse24(values0=v0, values1=v1, codes=codes,
                    shape=tuple(w.shape))


def prune_compress_24(w: torch.Tensor, rank_mxu: bool = False,
                      block_rows: Optional[int] = None,
                      block_k: Optional[int] = None, pad128: bool = True,
                      pack_rank: bool = False, fold_rows: bool = False,
                      fold: int = 1) -> Sparse24:
    """Fused prune+compress: dense ``w (..., m, k)`` to :class:`Sparse24`
    in one kernel pass (one read of the dense weights, compact writes).

    The planes are bit-identical to ``compress_24(prune_nm(w)[0])``.
    ``fold=2`` pads k to a multiple of 64, compresses the free row-major
    view ``[rows, kp] -> [rows/2, 2*kp]`` and keeps the planes folded
    (``[2*k4, rows/2]``, ``Sparse24.fold = 2``); :func:`spmm_24` contracts
    them directly. ``rank_mxu``, ``block_rows``, ``block_k``, ``pad128``,
    ``pack_rank`` and ``fold_rows`` are TPU formulations and tilings of the
    same selection: accepted and ignored (``fold_rows`` returns the standard
    planes, as it does in the JAX package).
    """
    k = w.shape[-1]
    w2 = w.reshape(-1, k)
    if fold > 1:
        if fold != 2:
            raise ValueError(f"fold {fold} unsupported (use 2)")
        rows = w2.shape[0]
        if rows % fold:
            raise ValueError(f"rows {rows} % fold {fold} != 0")
        kp = -(-k // 64) * 64  # compress_24's k padding quantum
        w2 = F.pad(w2, (0, kp - k)) if kp != k else w2
        w2 = w2.reshape(rows // fold, fold * kp)
    if _build.use_kernel(w):
        v0, v1, codes = prune_compress_24_cuda(w2)
    else:
        v0, v1, codes = prune_compress_24_plain(w2)
    return Sparse24(values0=v0, values1=v1, codes=codes,
                    shape=tuple(w.shape), fold=fold)


def decompress_24(s: Sparse24) -> torch.Tensor:
    """Expand a :class:`Sparse24` back to its dense logical shape; fold=2
    planes are un-folded first (a compact-size copy)."""
    v0, v1, codes = s.values0, s.values1, s.codes
    if s.fold > 1:
        k4, rows = s.k4, v0.shape[1] * s.fold
        v0, v1, codes = (unfold_planes(p, s.fold, k4, rows)
                         for p in (v0, v1, codes))
    k = s.shape[-1]
    dense = expand_planes(v0, v1, codes).T[:, :k]
    return dense.reshape(s.shape)


def spmm_24_reference(s: Sparse24, b: torch.Tensor, *,
                      out_dtype=None) -> torch.Tensor:
    """Dense-oracle SpMM: decompress, then an f32 product."""
    a = decompress_24(s)
    out_dtype = out_dtype or torch.promote_types(a.dtype, b.dtype)
    return torch.matmul(a.to(torch.float32),
                        b.to(torch.float32)).to(out_dtype)


def spmm_24(
    s: Sparse24,
    b: torch.Tensor,
    *,
    out_dtype=None,
    alpha: float = 1.0,
    beta: float = 0.0,
    c: Optional[torch.Tensor] = None,
    transpose_a: bool = False,
    transpose_b: bool = False,
    transpose_out: bool = False,
    packed_codes: bool = False,
    tile: Optional[int] = None,
) -> torch.Tensor:
    """Structured-sparse matmul ``alpha * decompress(s) @ b + beta * c``.

    Batch dims of ``s`` share one ``b (k, n)`` (the reference's shared-B
    convention), folded into rows. ``transpose_out`` returns C^T ``[n, M]``
    (batch folded); ``c`` then has that layout, else ``(..., m, n)`` or
    ``[M, n]``. ``packed_codes`` hands the kernel split-half packed codes
    (:func:`pack_codes_fp`, packed per call here). Accumulation is f32;
    ``out_dtype`` defaults to the promoted type of ``s`` and ``b``.
    ``tile`` forces K3's tile, an index of ``spmm24_kernel.SP_TILES``
    (``None``: ``pick_tile``'s); the plain version ignores it. It is the
    counterpart of the TPU tiling (``block_m``, ``block_n``, ``block_k4``)
    that the JAX ``spmm_24`` takes, and what the tuner races.
    """
    if transpose_a:
        raise NotImplementedError(
            "transpose_a is unsupported for 2:4 SpMM: the compression axis "
            "must be the contraction axis (cusparseLt has the same "
            "restriction)")
    if transpose_b:
        b = b.transpose(-1, -2)
    *lead, m, k = s.shape
    n = b.shape[-1]
    out_dtype = out_dtype or torch.promote_types(s.dtype, b.dtype)
    if s.fold > 1:
        if transpose_out:
            raise NotImplementedError(
                "transpose_out is unsupported for folded operands (the "
                "[Mf, 2n] -> [M, n] un-fold is only free in row-major C)")
        if c is not None and beta != 0.0:
            c = c.reshape(-1, c.shape[-1])
        if _build.use_kernel(s.values0):
            # as in JAX: "no VJP -- train with fold=1 operands"
            _build.refuse_grad("spmm_24 on fold=2 operands", s.values0,
                               s.values1, b, c)
            fn = spmm24_fold_cuda
        else:
            fn = spmm24_fold_plain
        out = fn(s.values0, s.values1, s.codes, b, k_logical=k,
                 out_dtype=out_dtype, alpha=alpha, beta=beta, c=c, tile=tile)
        return out.reshape(*lead, m, n)
    if c is not None and beta != 0.0 and not transpose_out:
        c = torch.broadcast_to(c, (*lead, m, n)).reshape(-1, n)
    if c is None or beta == 0.0:
        c = None
    cfg = (k, out_dtype, alpha, beta, transpose_out, packed_codes, tile)
    args = (s.values0, s.values1, s.codes, b, c)
    out = (_Spmm24.apply(*args, cfg) if _build.needs_grad(*args)
           else _spmm24_forward(*args, cfg))
    if transpose_out:
        return out
    return out.reshape(*lead, m, n)


def _spmm24_forward(v0, v1, codes, b, c, cfg) -> torch.Tensor:
    """K3 on CUDA planes, its plain version on CPU ones."""
    k_logical, out_dtype, alpha, beta, transpose_out, packed, tile = cfg
    fn = spmm24_cuda if _build.use_kernel(v0) else spmm24_plain
    return fn(v0, v1, pack_codes_fp(codes) if packed else codes, b,
              k_logical=k_logical, out_dtype=out_dtype, alpha=alpha,
              beta=beta, c=c, transpose_out=transpose_out,
              packed_codes=packed, tile=tile)


class _Spmm24(torch.autograd.Function):
    """``spmm_24`` (fold=1) for autograd: the forward as the kernel or the
    plain version computes it, the backward the JAX package's VJP
    (``sparsifyme_tpu/ops/sparse24.py:_spmm24_bwd``) around the alpha/beta/c
    epilogue that JAX differentiates outside its core:
    ``g_core = alpha * g`` (C^T cotangents transposed first), ``db = A^T
    g_core`` with A decompressed once, ``dv0`` / ``dv1`` the k-major
    ``b g_core^T`` sampled at the kept positions ``codes >> 2`` and ``codes
    & 3`` of each group, ``dc = beta * g``; codes get none. Like the
    reference, the backward densifies: plain products, no kernel."""

    @staticmethod
    def forward(ctx, v0, v1, codes, b, c, cfg):
        ctx.save_for_backward(v0, v1, codes, b)
        ctx.cfg = cfg
        ctx.c_dtype = None if c is None else c.dtype
        return _spmm24_forward(v0, v1, codes, b, c, cfg)

    @staticmethod
    def backward(ctx, g):
        v0, v1, codes, b = ctx.saved_tensors
        k_logical, _, alpha, beta, transpose_out, _, _ = ctx.cfg
        need_v0, need_v1, _, need_b, need_c, _ = ctx.needs_input_grad
        g32 = g.to(torch.float32)
        gc = (g32.T if transpose_out else g32) * alpha  # [M, n]
        dv0 = dv1 = db = dc = None
        if need_b:
            a = expand_planes(v0, v1, codes)[:k_logical].to(torch.float32)
            db = (a @ gc).to(b.dtype)  # A^T g: a is A^T [k, M]
        if need_v0 or need_v1:
            k4, m = v0.shape
            dat = torch.zeros((4 * k4, m), dtype=torch.float32,
                              device=g.device)
            dat[:k_logical] = b.to(torch.float32) @ gc.T
            dat = dat.reshape(k4, 4, m)
            c64 = codes.to(torch.int64)
            if need_v0:
                dv0 = dat.gather(1, (c64 >> 2)[:, None]).squeeze(1).to(
                    v0.dtype)
            if need_v1:
                dv1 = dat.gather(1, (c64 & 3)[:, None]).squeeze(1).to(
                    v1.dtype)
        if need_c:
            dc = (beta * g32).to(ctx.c_dtype)
        return dv0, dv1, None, db, dc, None


def pack_codes_fp(codes: torch.Tensor) -> torch.Tensor:
    """Split-half packed codes ``[k4/2, M]``: byte ``j`` holds group ``j``
    in the low nibble and group ``j + k4/2`` in the high nibble."""
    k4 = codes.shape[-2]
    if k4 % 2:
        raise ValueError(f"k4 {k4} must be even")
    half = k4 // 2
    return (codes[..., :half, :] | (codes[..., half:, :] << 4)).to(
        torch.uint8)


def pack_codes(codes: torch.Tensor) -> torch.Tensor:
    """Pack two uint8 group codes (4 bits used each) per byte: adjacent
    groups along the k-major group axis (``-2``), the first in the low
    nibble; an odd group count is padded with a zero code. The storage
    layout (0.125 B per logical element), distinct from the kernel's
    split-half :func:`pack_codes_fp`."""
    if codes.shape[-2] % 2:
        pad = torch.zeros_like(codes[..., :1, :])
        codes = torch.cat([codes, pad], dim=-2)
    *lead, k4p, m = codes.shape
    pairs = codes.reshape(*lead, k4p // 2, 2, m)
    return (pairs[..., 0, :] | (pairs[..., 1, :] << 4)).to(torch.uint8)


def unpack_codes(packed: torch.Tensor, k4: int) -> torch.Tensor:
    """Inverse of :func:`pack_codes`: the first ``k4`` group codes."""
    lo = packed & 0xF
    hi = (packed >> 4) & 0xF
    codes = torch.stack([lo, hi], dim=-2).reshape(
        *packed.shape[:-2], packed.shape[-2] * 2, packed.shape[-1])
    return codes[..., :k4, :].to(torch.uint8)
