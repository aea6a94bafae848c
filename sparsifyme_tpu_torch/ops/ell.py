"""Blocked-ELL format: build, densify, and batched SpMM.

Counterpart of ``sparsifyme_tpu.ops.ell``. :func:`spmm_ell` runs kernel K4
and :func:`spmm_ell_expand` kernel K5 on CUDA tensors, and their plain
versions on CPU tensors; building and densifying the format is plain
PyTorch on either device. Both SpMMs are differentiable in ``values`` and
``b`` (and ``c``) through the JAX package's VJPs, on either device.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .. import _build
from ..containers import BlockedEll
from ..utils import trace
from .kernels.ell_kernel import (ell_expand_spmm_cuda,
                                 ell_expand_spmm_plain, ell_spmm_cuda,
                                 ell_spmm_plain)
from .prune import prune_block_topk


def ell_from_dense(w: torch.Tensor, block_size: int, ell_blocks: int,
                   block_k: int = 0) -> BlockedEll:
    """Keep the top ``ell_blocks`` blocks (Frobenius norm) of every
    block-row of ``w (..., m, k)`` and pack them; indices sorted
    ascending."""
    pruned, cols = prune_block_topk(w, block_size, ell_blocks, block_k)
    values = ell_pack(pruned, cols, block_size, block_k)
    return BlockedEll(values=values, col_indices=cols, shape=tuple(w.shape),
                      block_size=block_size, block_k=block_k)


def ell_pack(w: torch.Tensor, col_indices: torch.Tensor, block_size: int,
             block_k: int = 0) -> torch.Tensor:
    """Gather the blocks of ``w (..., m, k)`` named by ``col_indices
    (..., m_blocks, ell)`` into packed values ``(..., m, ell*block_k)``."""
    *lead, m, k = w.shape
    bs, bk = block_size, block_k or block_size
    mb, kb = m // bs, k // bk
    ell = col_indices.shape[-1]
    blocks = w.reshape(*lead, mb, bs, kb, bk)
    idx = col_indices.to(torch.int64)[..., :, None, :, None].expand(
        *lead, mb, bs, ell, bk)
    return torch.gather(blocks, -2, idx).reshape(*lead, m, ell * bk)


def ell_to_dense(e: BlockedEll) -> torch.Tensor:
    """Scatter packed ELL values back to dense (repeated block columns
    add, as in the JAX op)."""
    *lead, m, k = e.shape
    bs, bk = e.block_size, e.bk
    mb, kb = m // bs, k // bk
    ell = e.ell_blocks
    vals = e.values.reshape(*lead, mb, bs, ell, bk)
    idx = e.col_indices.to(torch.int64)[..., :, None, :, None].expand(
        *lead, mb, bs, ell, bk)
    dense = torch.zeros((*lead, mb, bs, kb, bk), dtype=e.values.dtype,
                        device=e.values.device)
    dense.scatter_add_(-2, idx, vals)
    return dense.reshape(*lead, m, k)


def spmm_ell_reference(e: BlockedEll, b: torch.Tensor, *,
                       out_dtype=None) -> torch.Tensor:
    """Dense-oracle SpMM: densify, then an f32 product."""
    a = ell_to_dense(e)
    out_dtype = out_dtype or torch.promote_types(a.dtype, b.dtype)
    return torch.matmul(a.to(torch.float32),
                        b.to(torch.float32)).to(out_dtype)


def spmm_ell(
    e: BlockedEll,
    b: torch.Tensor,
    *,
    out_dtype=None,
    alpha: float = 1.0,
    beta: float = 0.0,
    c: Optional[torch.Tensor] = None,
    transpose_a: bool = False,
    transpose_b: bool = False,
    transpose_out: bool = False,
    block_n: Optional[int] = None,
    splits: Optional[int] = None,
) -> torch.Tensor:
    """Batched Blocked-ELL SpMM ``alpha * ell_to_dense(e) @ b + beta * c``
    with the zero blocks skipped.

    Batch dims of ``e`` share one ``b (k, n)``, folded into rows.
    ``transpose_out`` returns C^T ``[n, M]`` (batch folded); ``c`` then has
    that layout, else ``(..., m, n)`` or ``[M, n]``. Accumulation is f32;
    ``out_dtype`` defaults to the promoted type of ``e`` and ``b``.
    ``block_n`` (a tile width of ``ell_kernel.TILE_NS``) and ``splits``
    (split-k count) force K4's Hopper-tile plan, the counterparts of the
    JAX op's ``block_n`` / ``split_n``; ``None`` keeps ``ell_plan``'s pick.
    On the card a plan the tile cannot take raises ``ValueError`` before
    the launch; the plain version ignores both.
    """
    call = trace.begin("sparsifyme.spmm_ell", "prep")
    try:
        if transpose_a:
            raise NotImplementedError(
                "transpose_a is unsupported for Blocked-ELL SpMM: the block "
                "column indices address the contraction axis; densify and use "
                "batched_gemm(transpose_a=True) instead")
        if transpose_b:
            b = b.transpose(-1, -2)
        *lead, m, k = e.shape
        n = b.shape[-1]
        out_dtype = out_dtype or torch.promote_types(e.dtype, b.dtype)
        values = e.values.reshape(-1, e.values.shape[-1])
        cols = e.col_indices.reshape(-1, e.col_indices.shape[-1])
        if c is not None and beta != 0.0 and not transpose_out:
            c = torch.broadcast_to(c, (*lead, m, n)).reshape(-1, n)
        if c is None or beta == 0.0:
            c = None
        cfg = (e.block_size, e.block_k, out_dtype, alpha, beta, transpose_out,
               block_n, splits)
        args = (values, cols, b, c)
        out = (_SpmmEll.apply(*args, cfg) if _build.needs_grad(*args)
               else _ell_forward(*args, cfg))
        if transpose_out:
            return out
        return out.reshape(*lead, m, n)
    finally:
        if call:
            trace.end(call)


def _ell_forward(values, cols, b, c, cfg) -> torch.Tensor:
    """K4 on CUDA values, its plain version on CPU ones."""
    bs, bk, out_dtype, alpha, beta, transpose_out, block_n, splits = cfg
    if _build.use_kernel(values):
        fn = ell_spmm_cuda
    else:
        trace.mark("plain")
        fn = ell_spmm_plain
    return fn(values, cols, b, block_size=bs, block_k=bk,
              out_dtype=out_dtype, alpha=alpha, beta=beta, c=c,
              transpose_out=transpose_out, block_n=block_n, splits=splits)


def _ell_adjoints(values, cols, b, gc, bs, bk, need_values, need_b):
    """The JAX package's ELL adjoints for row-major ``values [M, ell*bk]``
    and the product's cotangent ``gc [M, n]`` (f32): A densified once
    (repeated block columns add, as ``ell_to_dense`` does), ``db = A^T
    gc`` and ``dvalues = ell_pack(gc B^T)``. B is zero-padded to whole
    blocks; ``db`` keeps B's rows."""
    kb = b.shape[0]
    kp = -(-kb // bk) * bk
    m = values.shape[0]
    dvalues = db = None
    if need_b:
        a = ell_to_dense(BlockedEll(values=values.to(torch.float32),
                                    col_indices=cols, shape=(m, kp),
                                    block_size=bs, block_k=bk))
        db = (a.T @ gc)[:kb].to(b.dtype)
    if need_values:
        bp = F.pad(b.to(torch.float32), (0, 0, 0, kp - kb))
        dvalues = ell_pack(gc @ bp.T, cols, bs, bk).to(values.dtype)
    return dvalues, db


class _SpmmEll(torch.autograd.Function):
    """``spmm_ell`` for autograd: the forward as K4 or its plain version
    computes it, the backward the JAX package's VJP
    (``sparsifyme_tpu/ops/ell.py:_spmm_ell_bwd``) around the alpha/beta/c
    epilogue that JAX differentiates outside its core: ``g_core = alpha *
    g`` (C^T cotangents transposed first), then :func:`_ell_adjoints`, and
    ``dc = beta * g``; ``col_indices`` get none. Like the reference, the
    backward densifies: plain products, no kernel."""

    @staticmethod
    def forward(ctx, values, cols, b, c, cfg):
        ctx.save_for_backward(values, cols, b)
        ctx.cfg = cfg
        ctx.c_dtype = None if c is None else c.dtype
        return _ell_forward(values, cols, b, c, cfg)

    @staticmethod
    def backward(ctx, g):
        values, cols, b = ctx.saved_tensors
        bs, bk, _, alpha, beta, transpose_out, _, _ = ctx.cfg
        need_values, _, need_b, need_c, _ = ctx.needs_input_grad
        g32 = g.to(torch.float32)
        gc = (g32.T if transpose_out else g32) * alpha
        dvalues, db = _ell_adjoints(values, cols, b, gc, bs, bk or bs,
                                    need_values, need_b)
        dc = (beta * g32).to(ctx.c_dtype) if need_c else None
        return dvalues, None, db, dc, None


def ell_values_kmajor(e: BlockedEll) -> torch.Tensor:
    """Batch-folded k-major packed values ``[ell*bk, M]``, the layout K5
    reads. Build it once with the format, not inside the hot call."""
    return e.values.reshape(-1, e.values.shape[-1]).T.contiguous()


def spmm_ell_expand(
    e: BlockedEll,
    b: torch.Tensor,
    *,
    out_dtype=None,
    transpose_out: bool = False,
    values_km: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Blocked-ELL SpMM in the expand formulation, the small-k
    counterpart of :func:`spmm_ell`.

    Reads k-major values (pass ``values_km`` from :func:`ell_values_kmajor`
    to keep the relayout out of the hot path). Where two slots of a
    block-row name the same block column, the last slot's block is the one
    multiplied, as in the JAX expand kernel (:func:`spmm_ell` sums them).
    ``transpose_out`` returns C^T ``[n, M]`` (batch folded).
    """
    *lead, m, k = e.shape
    n = b.shape[-1]
    out_dtype = out_dtype or torch.promote_types(e.dtype, b.dtype)
    if values_km is None:
        values_km = ell_values_kmajor(e)
    cols = e.col_indices.reshape(-1, e.col_indices.shape[-1])
    cfg = (e.block_size, e.block_k, out_dtype, transpose_out)
    args = (values_km, cols, b)
    out = (_SpmmEllExpand.apply(*args, cfg) if _build.needs_grad(*args)
           else _expand_forward(*args, cfg))
    if transpose_out:
        return out
    return out.reshape(*lead, m, n)


def _expand_forward(values_km, cols, b, cfg) -> torch.Tensor:
    """K5 on CUDA values, its plain version on CPU ones."""
    bs, bk, out_dtype, transpose_out = cfg
    fn = (ell_expand_spmm_cuda if _build.use_kernel(values_km)
          else ell_expand_spmm_plain)
    return fn(values_km, cols, b, block_size=bs, block_k=bk,
              out_dtype=out_dtype, transpose_out=transpose_out)


class _SpmmEllExpand(torch.autograd.Function):
    """``spmm_ell_expand`` for autograd: the forward as K5 or its plain
    version computes it, the backward the JAX package's VJP
    (``sparsifyme_tpu/ops/ell.py:_spmm_ell_expand_bwd``): the adjoints of
    :func:`_ell_adjoints` for ``values_km.T``, ``dvalues`` transposed back
    to k-major. As written there, A is densified with ``ell_to_dense``,
    which adds repeated block columns, while the forward keeps the last
    slot: for a repeated column the backward is that of the summed
    product."""

    @staticmethod
    def forward(ctx, values_km, cols, b, cfg):
        ctx.save_for_backward(values_km, cols, b)
        ctx.cfg = cfg
        return _expand_forward(values_km, cols, b, cfg)

    @staticmethod
    def backward(ctx, g):
        values_km, cols, b = ctx.saved_tensors
        bs, bk, _, transpose_out = ctx.cfg
        need_values, _, need_b, _ = ctx.needs_input_grad
        g32 = g.to(torch.float32)
        dvalues, db = _ell_adjoints(values_km.T, cols, b,
                                    g32.T if transpose_out else g32, bs,
                                    bk or bs, need_values, need_b)
        return None if dvalues is None else dvalues.T, None, db, None
