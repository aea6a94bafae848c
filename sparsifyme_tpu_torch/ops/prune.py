"""Pruning ops: N:M magnitude prune, its structural check, and the
block top-k prune behind Blocked-ELL.

Counterpart of ``sparsifyme_tpu.ops.prune``. :func:`prune_nm` runs kernel
K1 on CUDA tensors and its plain version on CPU tensors. The other ops are
plain PyTorch on either device, as their JAX counterparts are plain XLA.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from .. import _build
from .kernels.prune_kernel import prune_nm_cuda, prune_nm_plain


def prune_nm(w: torch.Tensor, n: int = 2,
             m: int = 4) -> Tuple[torch.Tensor, torch.Tensor]:
    """N:M magnitude prune along the last axis; returns ``(pruned, mask)``.

    Keeps the ``n`` largest-magnitude elements of every contiguous group of
    ``m``; equal magnitudes rank by position, later positions winning. The
    last axis acts as zero-padded to a multiple of ``m``.
    """
    if _build.use_kernel(w):
        return prune_nm_cuda(w, n, m)
    return prune_nm_plain(w, n, m)


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
