"""Wrappers of kernels K1 (N:M prune) and K2 (2:4 compress), each beside
its plain PyTorch version.

K1 ``csrc/prune_nm.cu`` replaces
``sparsifyme_tpu/ops/kernels/prune_kernel.py:prune_nm_pallas``; K2
``csrc/compress24.cu`` replaces ``compress_24_pallas`` from the same file
and also ``prune_compress_24_pallas`` (``:577``), the fused
prune+compress: K2 ranks the dense rows itself, and a kept element always
outranks what pruning zeroes, so compressing unpruned input gives the
planes of ``compress_24(prune_nm(w))`` bit for bit. The fused route
(:func:`prune_compress_24_cuda`) launches K2 on the dense rows and keeps
its own launch count. Both kernels are bound by device-memory bytes on
the H100; the sources say how their designs meet that bound.

Ranking semantics (shared with the JAX package): order by
(|value|, position), later positions win magnitude ties; keep the top
``n`` of every contiguous group of ``m``.
"""

from __future__ import annotations

import collections
import functools
from typing import Tuple

import torch
import torch.nn.functional as F

from ... import _build

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _round_up(a: int, b: int) -> int:
    return -(-a // b) * b


def _beat_count(groups: torch.Tensor) -> torch.Tensor:
    """For ``groups [..., g, m]`` of magnitudes: how many members of each
    group outrank each member (larger magnitude, or equal magnitude at a
    later position)."""
    m = groups.shape[-1]
    ai = groups[..., :, None]   # challenger i
    aj = groups[..., None, :]   # member j
    pos = torch.arange(m, device=groups.device)
    later = pos[:, None] > pos[None, :]
    beats = (ai > aj) | ((ai == aj) & later)
    return beats.sum(dim=-2)


def prune_nm_plain(w: torch.Tensor, n: int = 2,
                   m: int = 4) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K1: ``(w * mask, mask)``, mask in ``w``'s type."""
    *lead, k = w.shape
    kp = _round_up(k, m)
    wp = F.pad(w, (0, kp - k))
    cnt = _beat_count(wp.abs().reshape(*lead, kp // m, m))
    mask = (cnt < n).reshape(*lead, kp)[..., :k].to(w.dtype)
    return w * mask, mask


def prune_nm_cuda(w: torch.Tensor, n: int = 2,
                  m: int = 4) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K1 on a CUDA tensor; returns ``(pruned, mask)``."""
    if not w.is_cuda:
        raise ValueError("prune_nm_cuda needs a CUDA tensor")
    if w.dtype not in DTYPE_CODES:
        raise TypeError(f"prune_nm kernel takes float32 or bfloat16, not "
                        f"{w.dtype}")
    if not 1 <= m <= 32:
        raise ValueError(f"group size m={m} must be in 1..32")
    if w.ndim == 0 or w.shape[-1] == 0:
        raise ValueError(f"cannot prune shape {tuple(w.shape)}")
    w = w.contiguous()
    k = w.shape[-1]
    rows = w.numel() // k
    out = torch.empty_like(w)
    mask = torch.empty_like(w)
    launch = _build.load("prune_nm", "prune_nm_launch", "ppp" "l" "iiii" "p")
    _build.check(launch(  # (w, out, mask, rows, k, n, m, dtype, stream)
        w.data_ptr(), out.data_ptr(), mask.data_ptr(), rows, k, n, m,
        DTYPE_CODES[w.dtype], _build.stream_ptr(w)), "prune_nm")
    prune_nm_cuda.launches += 1
    return out, mask


prune_nm_cuda.launches = 0


def compress_24_plain(
        w2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of K2: row-major ``w2 [M, k]`` to k-major planes
    ``(v0, v1, codes)`` of shape ``[kp/4, M]``, kp = k rounded up to 64."""
    rows, k = w2.shape
    kp = _round_up(k, 64)
    g = F.pad(w2, (0, kp - k)).reshape(rows, kp // 4, 4)
    keep = _beat_count(g.abs()) < 2          # exactly two per group
    before = torch.cumsum(keep.to(torch.int32), dim=-1) - keep.to(torch.int32)
    pos = torch.arange(4, device=w2.device)
    is0 = keep & (before == 0)
    is1 = keep & (before == 1)
    i0 = (is0 * pos).sum(-1)
    i1 = (is1 * pos).sum(-1)
    v0 = torch.gather(g, -1, i0[..., None])[..., 0]
    v1 = torch.gather(g, -1, i1[..., None])[..., 0]
    codes = (i0 * 4 + i1).to(torch.uint8)
    return (v0.T.contiguous(), v1.T.contiguous(), codes.T.contiguous())


def prune_compress_24_plain(
        w2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the fused route: :func:`compress_24_plain` on the
    dense (unpruned) rows."""
    return compress_24_plain(w2)


# --- the tile plan of K2 (csrc/compress24.cu) --------------------------------

COMPRESS_KMAX = 160       # k up to this: a tile holds whole rows
COMPRESS_KTILE = 64       # columns of a tile above it (16 groups)
COMPRESS_TILE_BYTES = 16384  # input bytes of a tile, about
COMPRESS_MAX_ROWS = 128

CompressPlan = collections.namedtuple(
    "CompressPlan", "rows_per_tile k_tile span units")


@functools.lru_cache(maxsize=1024)
def compress_plan(rows: int, k: int, itemsize: int) -> CompressPlan:
    """K2's tiles for ``w [rows, k]`` of ``itemsize``-byte elements: R rows
    (a multiple of 8, at most 128) by KT columns, KT = kp (whole rows, one
    contiguous span a tile) where ``k <= COMPRESS_KMAX``, else 64. R takes
    about ``COMPRESS_TILE_BYTES`` of input, and at least the rows of one
    128-byte line of a plane row (``128 // itemsize``): the stores of a
    tile are then whole lines. Unit ``u`` is row tile ``u // (kp / KT)``,
    k-tile ``u % (kp / KT)``; the kernel launches as many persistent
    blocks as fit on the card (at most ``units``), and block ``x`` of
    ``grid`` takes units ``x + i * grid``."""
    kp = _round_up(k, 64)
    span = k <= COMPRESS_KMAX
    kt = kp if span else COMPRESS_KTILE
    ld = k if span else COMPRESS_KTILE
    fits = COMPRESS_TILE_BYTES // (ld * itemsize) // 8 * 8
    rt = min(COMPRESS_MAX_ROWS, max(128 // itemsize, fits))
    return CompressPlan(rt, kt, span, -(-rows // rt) * (kp // kt))


def compress_walk(plan: CompressPlan, rows: int, k: int, itemsize: int,
                  grid: int):
    """Replay K2's loops on the CPU with ``grid`` persistent blocks:
    ``(loads, writes)``, how often each element of ``w [rows, k]`` is
    copied into shared memory (``load_tile``) and how often each ``(group,
    row)`` of the ``[kp/4, rows]`` planes is stored (``store_tile``), over
    every block's units."""
    kp = _round_up(k, 64)
    rt, kt = plan.rows_per_tile, plan.k_tile
    ktiles = kp // kt
    unit = 16 // itemsize
    loads = torch.zeros(rows * k, dtype=torch.int32)
    writes = torch.zeros((kp // 4, rows), dtype=torch.int32)
    groups, octs = kt // 4, rt // 8
    it = torch.arange(groups * octs)
    oct_, gl = it % octs, it // octs
    eight = torch.arange(8)
    qr = COMPRESS_KTILE // unit  # 16-byte pieces of a k-tile row
    for block in range(grid):
        for u in range(block, plan.units, grid):
            r0, c0 = (u // ktiles) * rt, (u % ktiles) * kt
            n = min(rt, rows - r0)
            if plan.span:  # chunks and a tail of one contiguous span
                loads[r0 * k:(r0 + n) * k] += 1
            else:  # 16-byte row pieces, masked at k
                q = torch.arange(n * qr)
                r = r0 + q // qr
                el = (c0 + (q % qr) * unit)[:, None] + torch.arange(unit)
                rr = r[:, None].expand_as(el)
                keep = el < k
                loads.index_put_((rr[keep] * k + el[keep],),
                                 torch.ones(int(keep.sum()),
                                            dtype=torch.int32),
                                 accumulate=True)
            row = (r0 + oct_ * 8)[:, None] + eight
            grp = (c0 // 4 + gl)[:, None].expand_as(row)
            keep = row < rows
            writes.index_put_((grp[keep], row[keep]),
                              torch.ones(int(keep.sum()), dtype=torch.int32),
                              accumulate=True)
    return loads.reshape(rows, k), writes


def _compress_launch(
        w2: torch.Tensor,
        what: str) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    if not w2.is_cuda:
        raise ValueError(f"{what} needs a CUDA tensor")
    if w2.dtype not in DTYPE_CODES:
        raise TypeError(f"compress_24 kernel takes float32 or bfloat16, not "
                        f"{w2.dtype}")
    if w2.ndim != 2 or w2.shape[1] == 0:
        raise ValueError(f"expected [M, k] with k > 0, got {tuple(w2.shape)}")
    w2 = w2.contiguous()
    rows, k = w2.shape
    k4 = _round_up(k, 64) // 4
    plan = compress_plan(rows, k, w2.element_size())
    v0 = torch.empty((k4, rows), dtype=w2.dtype, device=w2.device)
    v1 = torch.empty_like(v0)
    codes = torch.empty((k4, rows), dtype=torch.uint8, device=w2.device)
    launch = _build.load("compress24", "compress24_launch",
                         "pppp" "iiiiiii" "p")
    _build.check(launch(  # (w, v0, v1, codes, M, k, K4, R, KT, dtype,
        #                     device, stream)
        w2.data_ptr(), v0.data_ptr(), v1.data_ptr(), codes.data_ptr(), rows,
        k, k4, plan.rows_per_tile, plan.k_tile, DTYPE_CODES[w2.dtype],
        _build.device_index(w2), _build.stream_ptr(w2)), what)
    return v0, v1, codes


def compress_24_cuda(
        w2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch K2 on a CUDA tensor ``w2 [M, k]``; returns the planes."""
    out = _compress_launch(w2, "compress_24_cuda")
    compress_24_cuda.launches += 1
    return out


compress_24_cuda.launches = 0


def prune_compress_24_cuda(
        w2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The fused prune+compress route: launch K2 on the dense rows
    ``w2 [M, k]``; returns the planes of the pruned matrix."""
    out = _compress_launch(w2, "prune_compress_24_cuda")
    prune_compress_24_cuda.launches += 1
    return out


prune_compress_24_cuda.launches = 0
