"""Wrapper of kernel K6 (segmented block-row COO SpMM) beside its plain
PyTorch version, the block-row packer that builds their operand, and the
layout and plan of the Hopper kernel.

K6 ``csrc/coo_spmm.cu`` replaces
``sparsifyme_tpu/ops/kernels/coo_kernel.py:spmm_coo_pallas`` (``:169``). Its
``"matmul"`` and ``"slices"`` gathers are two TPU formulations of one
function; K6 is the one kernel behind both names. Its bound at the shapes
of BASELINE config 2 is the operations (2 * nnz * N f32 multiply-adds on
the CUDA cores); the source says how its design meets that.

Contract: packed planes ``vals2`` (f32 or bf16), ``cols2`` and ``roff2``
(int32), each ``[mb, E]`` with ``mb = ceil(m / block_rows)`` and ``E`` a
multiple of :data:`GROUP`, as :func:`pack_coo_blockrows` builds them; ``b
[batch, k, n]`` (f32 or bf16), every batch sharing the one sparse A. The
result is f32 ``[batch, m, n]`` with ``out[t, i*bm + roff2[i, s]] +=
vals2[i, s] * b[t, cols2[i, s]]`` over every slot ``s`` of block-row
``i``: duplicate entries sum, padding entries (value 0) are multiplied like
any other, rows at or past ``m`` are dropped, and an entry whose column
lies outside ``[0, k)`` or whose row offset lies outside ``[0,
block_rows)`` contributes nothing. The TPU kernel takes B with the batch
folded into its columns, ``[k, batch * n]``; K6 reads ``[batch, k, n]``
through strides instead, so nothing is copied. Unlike the TPU kernel, K6
has no limit on k.

K6 reads the planes through a layout derived from them once
(:func:`coo_layout`, kept out of timed calls as the packing is): within
each block-row the entries are sorted stably by (k-chunk of ``kc`` rows of
B, row offset), with an int32 table of where each (chunk, row) segment
starts. It is a permutation within block-rows, so the function is the
same; only the order of the f32 sums changes. :func:`coo_plan` picks the
route (B staged in shared memory, or gathered from L2 for very sparse A)
and the split of the k-chunks over blocks from the shape and the nonzeros.
"""

from __future__ import annotations

import collections
import functools
from typing import Optional

import torch

from ... import _build
from .prune_kernel import DTYPE_CODES
from .spmm24_kernel import H100_SMS, sm_count

# (vals, cols, starts, b, out, ws, mb, E, bm, m, k, n, batch, kc, n_chunks,
#  route, splits, chunks_per_split, bdtype, device, stream)
COO_SPMM = _build.Entry("coo_spmm", "coo_spmm_launch",
                        "pppppp" "iiiiiiiiiiiiii" "p")
GROUP = 8  # E must be a multiple of this, as on the TPU
SLOT_QUANTUM = 128  # the packer pads E to a multiple of this, as on the TPU
MAX_BLOCK_ROWS = 256  # largest block-row edge
MAX_BLOCK_ROW_COUNT = 65535  # K6's grid y dimension, over row groups

# --- the layout and plan of the Hopper kernel (csrc/coo_spmm.cu) ------------

ROW_GROUP = 128  # rows of C a block holds in registers: 16 streams of 8
TILE_N = 128     # folded columns of C a block holds: 8 a thread
WINDOW = 2816    # entries a block stages in shared memory at a time
KC_CHOICES = (128, 64, 32, 16)  # rows of B a staged k-chunk, largest first
GATHER_KC = 1024  # rows of B a k-chunk where the plan gathers (few chunks)
MAX_SPLITS = 8
BLOCKS_PER_SM = 2
# The staged route pays where a staged B row feeds at least this many
# entries of a row group (ROW_GROUP * density), or where k is at most
# STAGE_ALWAYS_K (four staged chunks or fewer: it won at every sparsity
# down to 0.995 there); elsewhere each entry gathers its B row from L2
# (bench/coo_probe.py --routes: the routes crossed at a reuse of 1.96-2.94
# at k = 1152, 2304 and 4608, and 3.84-6.40 at k = 576).
STAGE_MIN_REUSE = 2.75
STAGE_ALWAYS_K = 512
# The plan's cost model, microseconds on one H100 SXM: multiply-adds a
# block retires per microsecond (either route), the second pass of a split
# and the device-memory rate (bench/coo_probe.py --plans).
FMA_PER_US_BLOCK = 15.6e3
REDUCE_US = 2.0
BYTES_PER_US = 3.35e6

CooLayout = collections.namedtuple(
    "CooLayout", "vals cols starts kc k nnz peak source")
CooPlan = collections.namedtuple(
    "CooPlan", "route splits chunks_per_split row_groups n_tiles grid")


def stages_b(rows: int, density: float, k: int) -> bool:
    """Whether K6 stages B in shared memory (route ``"staged"``) for a row
    group of ``rows`` rows of A at ``density`` and depth ``k``."""
    return rows * density >= STAGE_MIN_REUSE or k <= STAGE_ALWAYS_K


def coo_kc(nnz: int, mb: int, block_rows: int, k: int) -> int:
    """Rows of B in a k-chunk. Where :func:`coo_plan` will gather (very
    sparse A), :data:`GATHER_KC`: no B tile is staged, so fewer chunks
    only save the per-chunk barriers. Else the largest of
    :data:`KC_CHOICES` whose chunk is expected to hold at most three
    quarters of a :data:`WINDOW` of entries in one row group (a chunk
    seldom needs a second pass over its entries), else the smallest."""
    density = nnz / max(1, mb * block_rows * k)
    rows = min(block_rows, ROW_GROUP)
    if not stages_b(rows, density, k):
        return GATHER_KC
    for kc in KC_CHOICES:
        if rows * kc * density <= 0.75 * WINDOW:
            return kc
    return KC_CHOICES[-1]


def coo_layout(vals2, cols2, roff2, *, k: int, block_rows: int = 128,
               kc: Optional[int] = None) -> CooLayout:
    """K6's layout of the packed planes, on their device.

    Within each block-row the entries are sorted stably by (k-chunk
    ``col // kc``, row offset); entries whose column lies outside ``[0,
    k)`` or whose row offset lies outside ``[0, block_rows)``, and
    zero-valued entries at the (row, column) of an earlier zero-valued one,
    go last: K6 skips them, and they add nothing to the product.
    ``starts [mb, n_chunks * block_rows + 1]`` (int32) holds where the
    segment of (chunk c, row r) starts, at ``c * block_rows + r``; its last
    column is where the dropped entries start; an entry's row offset is
    that of its segment. Values become f32 (exactly). ``nnz`` counts the
    entries kept (padding included), ``peak`` those of the fullest
    block-row, and ``source`` the planes it was built from
    (:func:`check_layout`)."""
    mb, e = vals2.shape
    bm = block_rows
    cols = cols2.long()
    roff = roff2.long()
    valid = (cols >= 0) & (cols < k) & (roff >= 0) & (roff < bm)
    # A zero-valued entry adds 0 * B[col] (+-0, or NaN where B[col] is not
    # finite) to its row; a second one at the same (row, column) adds
    # nothing the first does not, so it goes with the dropped entries. The
    # packer's padding (value 0 at row 0, column 0 of every block-row) would
    # otherwise all fall to the first row's stream.
    code = torch.where(valid & (vals2 == 0), roff * k + cols,
                       torch.full_like(cols, -1))
    code, by_code = torch.sort(code, dim=1, stable=True)
    again = torch.zeros_like(valid)
    again[:, 1:] = (code[:, 1:] == code[:, :-1]) & (code[:, 1:] >= 0)
    valid &= ~torch.zeros_like(valid).scatter_(1, by_code, again)
    nnz = int(valid.sum())
    if kc is None:
        kc = coo_kc(nnz, mb, bm, k)
    n_chunks = max(1, -(-k // kc))
    key = torch.where(valid, (cols // kc) * bm + roff,
                      torch.full_like(cols, n_chunks * bm))
    key, order = torch.sort(key, dim=1, stable=True)
    bounds = torch.arange(n_chunks * bm + 1, device=key.device)
    starts = torch.searchsorted(key.contiguous(),
                                bounds.expand(mb, -1).contiguous(),
                                out_int32=True)
    return CooLayout(
        vals=torch.gather(vals2, 1, order).float(),
        cols=torch.gather(cols2.to(torch.int32), 1, order),
        starts=starts, kc=kc, k=k, nnz=nnz,
        peak=int(starts[:, -1].max()) if mb else 0,
        source=_identity(vals2, cols2, roff2))


def _identity(*planes):
    """Where each plane lies and its version counter, which every in-place
    write bumps."""
    return tuple((p.data_ptr(), p._version) for p in planes)


def check_layout(layout: CooLayout, vals2, cols2, roff2, *, k: int,
                 block_rows: int) -> None:
    """Refuse a layout that does not describe these planes: one built from
    other planes (another A of the same shape), from these before an
    in-place write, or for another k or ``block_rows``. K6 reads the layout
    alone, so a stale one would give a wrong product with no error."""
    if layout.source != _identity(vals2, cols2, roff2):
        raise ValueError("layout was built from other planes, or the planes "
                         "changed since: build it again with coo_layout")
    mb = vals2.shape[0]
    n_chunks = max(1, -(-k // layout.kc))
    if layout.k != k or tuple(layout.vals.shape) != tuple(vals2.shape) or \
            tuple(layout.starts.shape) != (mb, n_chunks * block_rows + 1):
        raise ValueError(f"layout of k={layout.k}, {tuple(layout.vals.shape)}"
                         f", starts {tuple(layout.starts.shape)} does not fit"
                         f" k={k}, planes {tuple(vals2.shape)} and "
                         f"block_rows={block_rows}")


@functools.lru_cache(maxsize=1024)
def coo_plan(mb: int, block_rows: int, k: int, kc: int, nnz: int, cols: int,
             sms: int = H100_SMS, routes=("staged", "gather"),
             split_counts=None, peak: Optional[int] = None
             ) -> Optional[CooPlan]:
    """The plan of one K6 launch over ``mb`` block-rows of ``block_rows``,
    depth ``k`` cut in chunks of ``kc``, ``nnz`` kept entries (``peak`` of
    them in the fullest block-row, else taken as the mean) and ``cols``
    folded columns (batch * n). Route: ``"staged"`` (B tiles in shared
    memory) where :func:`stages_b`, else ``"gather"`` (the staged route needs
    ``kc <= 128``: None if it is forced on a wider chunk). Splits: among
    ``split_counts`` (else 1 to :data:`MAX_SPLITS`) that leave no split
    without chunks, the least estimated time of the units (block-row x row
    group x n-tile x split) on ``sms * BLOCKS_PER_SM`` blocks (the lesser
    of two bounds: waves of units as large as the largest, or all the work
    spread over the blocks and the largest unit alone after it), plus a
    split's partials and second pass; ties go to fewer splits. The grid is ``(n-tiles,
    mb * row groups, splits)``; None where no split count fits."""
    rg = min(block_rows, ROW_GROUP)
    density = nnz / max(1, mb * block_rows * k)
    route = "staged" if stages_b(rg, density, k) else "gather"
    if route not in routes:
        route = routes[0]
    if route == "staged" and kc > KC_CHOICES[0]:
        return None  # a layout for the gather route: no B tile fits
    n_chunks = max(1, -(-k // kc))
    row_groups = -(-block_rows // ROW_GROUP)
    n_tiles = -(-cols // TILE_N)
    units = mb * row_groups * n_tiles
    slots = sms * BLOCKS_PER_SM
    # multiply-adds a block does: every unit's as large as the largest (a
    # full row group), in waves of `slots`; or all the work spread over the
    # slots and the largest unit alone after it. Both bound the time; the
    # smaller is the estimate (the first fits equal units, the second
    # units of unequal sizes, such as a short last block-row).
    total = nnz * n_tiles * TILE_N
    largest = (nnz / mb if peak is None else peak) * rg / block_rows \
        * TILE_N
    best = None
    for s in split_counts or range(1, min(MAX_SPLITS, n_chunks) + 1):
        per = -(-n_chunks // s)
        if (s - 1) * per >= n_chunks:
            continue  # the last split would be empty
        waves = -(-units * s // slots) * largest / s
        spread = total / slots + largest / s
        est = min(waves, spread) / FMA_PER_US_BLOCK
        if s > 1:  # f32 partials written and read again, C written
            est += REDUCE_US + 8 * s * mb * block_rows * cols / BYTES_PER_US
        if best is None or (est, s) < best[0]:
            best = ((est, s), CooPlan(route, s, per, row_groups, n_tiles,
                                      (n_tiles, mb * row_groups, s)))
    return best[1] if best else None


def card_plan(index: int, mb: int, block_rows: int, k: int, kc: int,
              nnz: int, cols: int, peak: int) -> CooPlan:
    """:func:`coo_plan` on card ``index``."""
    return coo_plan(mb, block_rows, k, kc, nnz, cols, sm_count(index),
                    peak=peak)


def plan_walk(plan: CooPlan, layout: CooLayout, block_rows: int):
    """Replay K6's loops on the CPU: for each block ``(n-tile, row unit,
    split)`` the k-chunks it walks and, per chunk, the windows of entries
    it stages; returns ``(entry_visits [mb, E], col_visits [splits, mb *
    row_groups, n_tiles * TILE_N], chunk_visits [mb * row_groups,
    n_tiles, n_chunks])``: how often each entry is multiplied (once by
    each n-tile if kept, never if dropped), how often each split writes
    each column of each row unit, and how often each (row unit, n-tile)
    walks each chunk."""
    mb, e = layout.vals.shape
    bm, kc = block_rows, layout.kc
    n_chunks = max(1, -(-layout.k // kc))
    starts = layout.starts.cpu()
    entry = torch.zeros((mb, e), dtype=torch.int32)
    colv = torch.zeros((plan.splits, mb * plan.row_groups,
                        plan.n_tiles * TILE_N), dtype=torch.int32)
    chunkv = torch.zeros((mb * plan.row_groups, plan.n_tiles, n_chunks),
                         dtype=torch.int32)
    streams, rps = ROW_GROUP // 8, 8
    for unit in range(mb * plan.row_groups):
        i, g = divmod(unit, plan.row_groups)
        for split in range(plan.splits):
            c0 = split * plan.chunks_per_split
            c1 = min(n_chunks, c0 + plan.chunks_per_split)
            for tile in range(plan.n_tiles):
                colv[split, unit, tile * TILE_N:(tile + 1) * TILE_N] += 1
                for c in range(c0, c1):
                    chunkv[unit, tile, c] += 1
                    rs = [int(starts[i, c * bm + min(g * ROW_GROUP + j, bm)])
                          for j in range(ROW_GROUP + 1)]
                    lo, hi = rs[0], rs[-1]
                    for w0 in range(lo, hi, WINDOW):
                        w1 = min(hi, w0 + WINDOW)
                        for st in range(streams):
                            for r in range(rps):
                                row = st * rps + r
                                a = max(rs[row], w0)
                                b = min(rs[row + 1], w1)
                                if a < b:
                                    entry[i, a:b] += 1
    return entry, colv, chunkv

def pack_coo_blockrows(rows: torch.Tensor, cols: torch.Tensor,
                       vals: torch.Tensor, m: int, *,
                       block_rows: int = 128):
    """Segment packing: COO entries -> per-block-row slots, on the device of
    ``vals``.

    Returns ``(vals2, cols2, roff2)``, each ``[mb, E]``, where ``E`` is the
    largest entry count of a block-row padded to a multiple of 128 (at
    least 128); padding entries carry value 0 at (roff 0, col 0).
    ``roff2`` is the row offset within the block-row. Entries keep their
    order within a block-row (a stable sort by block-row), so the planes
    are those of the JAX package's host packer
    (``coo_kernel.py:pack_coo_blockrows``) bit for bit, on either device.
    """
    dev = vals.device
    rows = rows.to(device=dev, dtype=torch.int64)
    cols = cols.to(device=dev, dtype=torch.int64)
    mb = -(-m // block_rows)
    br = rows // block_rows
    counts = torch.bincount(br, minlength=mb)
    e = int(counts.max()) if rows.numel() else 0
    e = max(SLOT_QUANTUM, -(-e // SLOT_QUANTUM) * SLOT_QUANTUM)
    vals2 = torch.zeros((mb, e), dtype=vals.dtype, device=dev)
    cols2 = torch.zeros((mb, e), dtype=torch.int32, device=dev)
    roff2 = torch.zeros((mb, e), dtype=torch.int32, device=dev)
    order = torch.sort(br, stable=True).indices
    rows, cols, vals, br = rows[order], cols[order], vals[order], br[order]
    starts = torch.cumsum(counts, 0) - counts
    slot = torch.arange(rows.numel(), device=dev) - starts[br]
    vals2[br, slot] = vals
    cols2[br, slot] = cols.to(torch.int32)
    roff2[br, slot] = (rows - br * block_rows).to(torch.int32)
    return vals2, cols2, roff2


def spmm_coo_plain(vals2, cols2, roff2, b, *, m: int,
                   block_rows: int = 128) -> torch.Tensor:
    """Plain version of K6: one ``index_add_`` of the gathered, scaled B
    rows per batch, in f32."""
    batch, k, n = b.shape
    mb = vals2.shape[0]
    roff = roff2.to(torch.int64)
    cols = cols2.to(torch.int64)
    rows = (torch.arange(mb, device=roff.device) * block_rows)[:, None] + roff
    keep = ((cols >= 0) & (cols < k) & (roff >= 0) & (roff < block_rows)
            & (rows < m))
    rows, cols = rows[keep], cols[keep]
    vals = vals2[keep].to(torch.float32)[:, None]
    out = torch.zeros((batch, m, n), dtype=torch.float32, device=b.device)
    for t in range(batch):  # one [nnz, n] f32 intermediate at a time
        out[t].index_add_(0, rows, b[t].index_select(0, cols).float() * vals)
    return out


def spmm_coo_cuda(vals2, cols2, roff2, b, *, m: int, block_rows: int = 128,
                  layout: Optional[CooLayout] = None) -> torch.Tensor:
    """Launch K6 on the layout of the planes (``layout``, which must have
    been built from these planes as they are, else built here by
    :func:`coo_layout`) under :func:`card_plan`'s plan."""
    if not (vals2.is_cuda and cols2.is_cuda and roff2.is_cuda and b.is_cuda):
        raise ValueError("spmm_coo_cuda needs CUDA tensors")
    if b.dim() != 3:
        raise ValueError(f"b must be [batch, k, n], not {tuple(b.shape)}")
    batch, k, n = b.shape
    if vals2.dim() != 2 or cols2.shape != vals2.shape or \
            roff2.shape != vals2.shape:
        raise ValueError(f"planes {tuple(vals2.shape)}, {tuple(cols2.shape)},"
                         f" {tuple(roff2.shape)} are not one [mb, E] shape")
    mb, e = vals2.shape
    if not 0 < block_rows <= MAX_BLOCK_ROWS:
        raise ValueError(f"block_rows {block_rows} not in [1, "
                         f"{MAX_BLOCK_ROWS}]")
    if mb != -(-m // block_rows):
        raise ValueError(f"{mb} block-rows of {block_rows} do not cover "
                         f"m={m}")
    if mb * -(-block_rows // ROW_GROUP) > MAX_BLOCK_ROW_COUNT:
        raise ValueError(f"{mb} block-rows > {MAX_BLOCK_ROW_COUNT}")
    if e % GROUP:
        raise ValueError(f"entry count {e} not a multiple of {GROUP}")
    if vals2.dtype not in DTYPE_CODES or b.dtype not in DTYPE_CODES:
        raise TypeError(f"coo_spmm kernel takes float32/bfloat16, not "
                        f"{vals2.dtype} values and {b.dtype} b")
    if layout is None:
        layout = coo_layout(vals2, cols2, roff2, k=k, block_rows=block_rows)
    else:
        check_layout(layout, vals2, cols2, roff2, k=k, block_rows=block_rows)
    out =torch.empty((batch, m, n), dtype=torch.float32, device=b.device)
    if out.numel() == 0:
        return out
    plan = card_plan(b.get_device(), mb, block_rows, k, layout.kc, layout.nnz,
                     batch * n, layout.peak)
    ws = (torch.empty((plan.splits, batch, m, n), dtype=torch.float32,
                      device=b.device) if plan.splits > 1 else None)
    b = b.contiguous()
    COO_SPMM(b.get_device(), layout.vals.data_ptr(), layout.cols.data_ptr(),
             layout.starts.data_ptr(), b.data_ptr(), out.data_ptr(),
             _build.ptr(ws), mb, e, block_rows, m, k, n, batch, layout.kc,
             max(1, -(-k // layout.kc)), 0 if plan.route == "staged" else 1,
             plan.splits, plan.chunks_per_split, DTYPE_CODES[b.dtype])
    spmm_coo_cuda.launches += 1
    return out


spmm_coo_cuda.launches = 0
