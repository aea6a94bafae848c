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
import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ... import _build
from ...utils import trace

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# (w, out, mask, rows, k, n, m, mode, R, KT, dtype, device, stream)
PRUNE_NM = _build.Entry("prune_nm", "prune_nm_launch",
                        "ppp" "l" "iiiiiiii" "p")
# (w, v0, v1, codes, M, k, K4, R, KT, dtype, device, stream)
COMPRESS24 = _build.Entry("compress24", "compress24_launch",
                          "pppp" "iiiiiii" "p")


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
    trace.mark("plan")
    plan = prune_plan(rows, k, m, w.element_size())
    trace.mark("alloc")
    out = torch.empty_like(w)
    mask = torch.empty_like(w)
    trace.mark("launch")
    PRUNE_NM(w.get_device(), w.data_ptr(), out.data_ptr(), mask.data_ptr(),
             rows, k, n, m, PRUNE_MODES[plan.mode], plan.rows_per_tile,
             plan.k_tile, DTYPE_CODES[w.dtype])
    prune_nm_cuda.launches += 1
    return out, mask


prune_nm_cuda.launches = 0


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """True where ``a`` and ``b`` have one shape and type and every element
    the same bits (the sign of a zero included), any NaN matching any NaN:
    K1's contract with :func:`prune_nm_plain` (NaN payloads differ between
    the CPU's and the card's arithmetic)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    b = b.to(a.device)
    nan = a.isnan()
    if not torch.equal(nan, b.isnan()):
        return False
    ints = {2: torch.int16, 4: torch.int32}[a.element_size()]
    return torch.equal(a.masked_fill(nan, 0).view(ints),
                       b.masked_fill(nan, 0).view(ints))


# --- the tile plan of K1 (csrc/prune_nm.cu) ----------------------------------

PRUNE_TILE_BYTES = 16384  # input bytes of a tile, at most
PRUNE_MODES = {"rows": 0, "cols": 1, "stream": 2}

PrunePlan = collections.namedtuple("PrunePlan",
                                   "mode rows_per_tile k_tile units")


@functools.lru_cache(maxsize=1024)
def prune_plan(rows: int, k: int, m: int, itemsize: int,
               tile_bytes: int = PRUNE_TILE_BYTES) -> PrunePlan:
    """K1's work units for ``w [rows, k]`` of ``itemsize``-byte elements
    and groups of ``m``. Each unit is a span of ``w`` whose pieces start
    16-byte aligned (``L = lcm(m, 16 / itemsize)``):

    * ``stream`` where ``k % m == 0`` (no group crosses a row) and a
      16-byte chunk holds whole groups (m = 4 or 8 and ``m * itemsize <=
      16``, the 2:4 pattern in either type): the matrix is one stream of
      ``k_tile = 16 / itemsize``-element chunks (the last may be short),
      ranked in registers; unit ``u`` is chunks ``256 u..256 u + 255``,
      one for each thread of a block;
    * ``rows`` else, where they fit: R whole rows (``k_tile = k``), R a
      multiple of ``16 / gcd(k * itemsize, 16)`` so that ``R * k``
      elements fill whole 16-byte chunks; unit ``u`` is rows ``u * R..``;
    * ``cols`` else: R row pieces of ``k_tile`` columns (a multiple of L);
      unit ``u`` is row tile ``u // ceil(k / k_tile)``, column tile
      ``u % ceil(k / k_tile)``.

    The kernel launches one block a unit; block ``x`` of a grid of
    ``grid`` blocks takes units ``x + i * grid``."""
    trace.count("plan_miss")  # the body runs on a cache miss only
    unit = 16 // itemsize
    if k % m == 0 and m in (4, 8) and unit % m == 0:
        return PrunePlan("stream", 1, unit, -(-rows * k // (unit * 256)))
    el = tile_bytes // itemsize
    align = unit // math.gcd(k, unit)
    if align * k <= el:
        rt = el // (align * k) * align
        return PrunePlan("rows", rt, k, -(-rows // rt))
    step = math.lcm(m, unit)
    kt = min(el // step * step, _round_up(k, step))
    rt = max(1, el // kt)
    return PrunePlan("cols", rt, kt, -(-rows // rt) * -(-k // kt))


PruneWalk = collections.namedtuple("PruneWalk",
                                   "loads stores ranked crossing")


def _tiles(plan: PrunePlan, rows: int, k: int, u: np.ndarray):
    """``tile_of`` for the units ``u``: ``(base, nrows, len, gld)``, one
    array each (a tile's row stride in shared memory is ``k_tile``)."""
    ktiles = -(-k // plan.k_tile) if plan.mode == "cols" else 1
    r0 = u // ktiles * plan.rows_per_tile
    c0 = u % ktiles * plan.k_tile
    nrows = np.minimum(plan.rows_per_tile, rows - r0)
    length = np.minimum(plan.k_tile, k - c0)
    return r0 * k + c0, nrows, length, np.full_like(u, k)


def _pieces(plan, tiles):
    """``(start, end)`` in ``w`` of each piece that ``load_tile`` and
    ``store_tile`` copy: one span of ``nrows * len`` elements a rows tile,
    ``nrows`` pieces of ``len`` a cols tile."""
    base, nrows, length, gld = tiles
    if plan.mode != "cols":
        return base, base + nrows * length
    r = np.arange(nrows.sum()) - np.repeat(np.cumsum(nrows) - nrows, nrows)
    start = np.repeat(base, nrows) + r * np.repeat(gld, nrows)
    return start, start + np.repeat(length, nrows)


def _rank_items(tiles, m, threads):
    """``(first, past)`` element of every group ``rank_tile`` ranks: thread
    t takes items t, t + threads, ... of a tile and steps its (row, group)
    by additions, as the kernel does."""
    base, nrows, length, gld = tiles
    gpr = -(-length // m)[:, None]
    ng = nrows[:, None] * gpr
    step_r = threads // gpr
    step_g = threads - step_r * gpr
    it = np.broadcast_to(np.arange(threads, dtype=base.dtype),
                         ng.shape[:1] + (threads,))
    r, g = it // gpr, it % gpr
    first, past = [], []
    while True:
        live = it < ng
        if not live.any():
            break
        col = g * m
        e0 = base[:, None] + r * gld[:, None] + col
        e1 = e0 + np.minimum(m, length[:, None] - col)
        whole = live.all()
        first.append(e0.ravel() if whole else e0[live])
        past.append(e1.ravel() if whole else e1[live])
        it = it + threads
        g = g + step_g
        r = r + step_r
        carry = g >= gpr
        g -= carry * gpr
        r += carry
    if not first:
        return np.zeros(0, base.dtype), np.zeros(0, base.dtype)
    return np.concatenate(first), np.concatenate(past)


def prune_walk(plan: PrunePlan, rows: int, k: int, m: int, itemsize: int,
               grid: int, threads: int = 256) -> PruneWalk:
    """Replay K1's loops on the CPU with ``grid`` blocks of ``threads``:
    how often each element of ``w [rows, k]`` is loaded
    (``loads``, ``[rows, k]``), how often each element of ``pruned`` and
    ``mask`` is stored (``stores``), how often each group ``(row, g)`` is
    ranked (``ranked``, ``[rows, ceil(k / m)]``, a group known by its
    first element), and how many ranked groups cross a row's end or stop
    short of it or of ``m`` (``crossing``). The store loops copy the
    pieces the load loops copied, piece for piece. ``itemsize`` is the
    element size the plan was made for."""
    total = rows * k
    ix = np.int32 if total < 2**31 - 2**16 else np.int64
    if plan.mode == "stream":  # thread t: chunks t, t + stride, ...
        unit = 16 // itemsize
        chunks = -(-total // unit)
        stride = grid * threads
        j = np.arange(-(-chunks // stride), dtype=ix)
        c = (np.arange(stride, dtype=ix)[:, None] + stride * j).ravel()
        c = c[c < chunks]
        start, end = c * unit, np.minimum(c * unit + unit, total)
        e0 = (c[:, None] * unit + np.arange(0, unit, m, dtype=ix)).ravel()
        e0 = e0[e0 < total]  # members past total: ranked, never stored
        e1 = e0 + m
    else:
        per = -(-plan.units // grid)
        u = (np.arange(grid, dtype=ix)[:, None]
             + grid * np.arange(per, dtype=ix)[None, :]).ravel()
        tiles = _tiles(plan, rows, k, u[u < plan.units])
        start, end = _pieces(plan, tiles)
        e0, e1 = _rank_items(tiles, m, threads)
    cover = np.cumsum(np.bincount(start, minlength=total + 1)
                      - np.bincount(end, minlength=total + 1))[:total]
    row = e0 // k
    c0 = e0 - row * k
    # in one row, at a group boundary of it, m wide or up to the row's end
    bad = (c0 % m != 0) | (e1 - e0 != np.minimum(m, k - c0))
    gk = -(-k // m)
    ranked = np.bincount((row * gk + c0 // m)[~bad], minlength=rows * gk)
    return PruneWalk(cover.reshape(rows, k), cover.reshape(rows, k),
                     ranked.reshape(rows, gk), int(bad.sum()))


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
    trace.count("plan_miss")  # the body runs on a cache miss only
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
    trace.mark("plan")
    plan = compress_plan(rows, k, w2.element_size())
    trace.mark("alloc")
    v0 = torch.empty((k4, rows), dtype=w2.dtype, device=w2.device)
    v1 = torch.empty_like(v0)
    codes = torch.empty((k4, rows), dtype=torch.uint8, device=w2.device)
    trace.mark("launch")
    COMPRESS24(w2.get_device(), w2.data_ptr(), v0.data_ptr(), v1.data_ptr(),
               codes.data_ptr(), rows, k, k4, plan.rows_per_tile,
               plan.k_tile, DTYPE_CODES[w2.dtype])
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
