"""Pruning ops: N:M magnitude prune, its structural check, the block
top-k prune behind Blocked-ELL, the per-block magnitude prune and the
unstructured threshold prune that feeds the COO path.

Counterpart of ``sparsifyme_tpu.ops.prune``. :func:`prune_nm` runs kernel
K1 on CUDA tensors and its plain version on CPU tensors. The other ops are
plain PyTorch on either device, as their JAX counterparts are plain XLA.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from .. import _build
from ..utils import trace
from .kernels.prune_kernel import prune_nm_cuda, prune_nm_plain


def prune_nm(w: torch.Tensor, n: int = 2,
             m: int = 4) -> Tuple[torch.Tensor, torch.Tensor]:
    """N:M magnitude prune along the last axis; returns ``(pruned, mask)``.

    Keeps the ``n`` largest-magnitude elements of every contiguous group of
    ``m``; equal magnitudes rank by position, later positions winning. The
    last axis acts as zero-padded to a multiple of ``m``.
    """
    call = trace.begin("sparsifyme.prune_nm", "prep")
    try:
        if _build.use_kernel(w):
            return prune_nm_cuda(w, n, m)
        trace.mark("plain")
        return prune_nm_plain(w, n, m)
    finally:
        if call:
            trace.end(call)


def prune_24(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """2:4 magnitude prune along the last axis."""
    return prune_nm(w, 2, 4)


def prune_check_nm(w: torch.Tensor, n: int = 2, m: int = 4) -> bool:
    """True when every m-group along the last axis has at most n
    nonzeros."""
    k = w.shape[-1]
    wp = F.pad(w, (0, (-k) % m))
    groups = wp.reshape(*w.shape[:-1], wp.shape[-1] // m, m)
    return bool(((groups != 0).sum(-1) <= n).all())


def prune_check_24(w: torch.Tensor) -> bool:
    return prune_check_nm(w, 2, 4)


def prune_block_topk(w: torch.Tensor, block_size: int, ell_blocks: int,
                     block_k: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Keep the top ``ell_blocks`` blocks (by L2 norm) of every block-row.

    Returns ``(pruned, col_indices)`` with int32 ``col_indices`` of shape
    ``(..., m_blocks, ell_blocks)`` sorted ascending. Equal norms keep the
    lower block index first (a stable descending sort), which is the order
    ``jax.lax.top_k`` gives.
    """
    *lead, mm, kk = w.shape
    bk = block_k or block_size
    if mm % block_size or kk % bk:
        raise ValueError(f"{mm}x{kk} not divisible by block {block_size}x{bk}")
    mb, kb = mm // block_size, kk // bk
    if ell_blocks > kb:
        raise ValueError(f"ell_blocks {ell_blocks} > k_blocks {kb}")
    blocks = w.reshape(*lead, mb, block_size, kb, bk)
    norms = blocks.to(torch.float32).square().sum(dim=(-3, -1))
    order = torch.sort(norms, dim=-1, descending=True, stable=True).indices
    cols = torch.sort(order[..., :ell_blocks], dim=-1).values
    keep = torch.zeros(norms.shape, dtype=torch.bool, device=w.device)
    keep.scatter_(-1, cols, True)
    mask = keep[..., :, None, :, None].to(w.dtype)
    pruned = (blocks * mask).reshape(*lead, mm, kk)
    return pruned, cols.to(torch.int32)


def prune_block_magnitude(w: torch.Tensor, block: Tuple[int, int] = (2, 2),
                          sparsity: float = 0.5
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Magnitude prune per ``(bm, bn)`` block; returns ``(pruned, mask)``.

    Zeroes the ``floor(bm * bn * sparsity)`` smallest-magnitude elements of
    every block (the reference's ``sparsify.hxx:41`` drop count). Equal
    magnitudes rank by position within the block (row-major), later
    positions winning, as the JAX op's ranking computes (its docstring
    says the opposite; the code is the reference). Leading dims batch;
    the last two must divide by the block shape.
    """
    bm, bn = block
    *lead, m, n = w.shape
    if m % bm or n % bn:
        raise ValueError(f"matrix {m}x{n} not divisible by block {block}")
    bs = bm * bn
    drop = int(bs * sparsity)
    if drop <= 0:
        return w, torch.ones_like(w)
    mb, nb = m // bm, n // bn
    flat = w.reshape(*lead, mb, bm, nb, bn).transpose(-3, -2).reshape(
        *lead, mb, nb, bs)
    # A stable ascending sort ranks equal magnitudes by position, so the
    # later of two ties ranks higher; the top bs - drop ranks survive.
    order = torch.sort(flat.abs().to(torch.float32), dim=-1,
                       stable=True).indices
    ranks = torch.empty_like(order).scatter_(
        -1, order, torch.arange(bs, device=w.device).expand_as(order))
    keep = (ranks >= drop).reshape(*lead, mb, nb, bm, bn).transpose(-3, -2)
    mask = keep.reshape(*lead, m, n).to(w.dtype)
    return w * mask, mask


def prune_threshold(w: torch.Tensor,
                    threshold: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Unstructured magnitude-threshold prune: zero ``|w| < threshold``;
    returns ``(pruned, mask)``."""
    mask = (w.abs() >= threshold).to(w.dtype)
    return w * mask, mask
