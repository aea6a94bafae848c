"""Wrappers of kernels K4 (Blocked-ELL SpMM, gather formulation) and K5
(the expand formulation), each beside its plain PyTorch version.

K4 ``csrc/ell_spmm.cu`` replaces
``sparsifyme_tpu/ops/kernels/ell_kernel.py:ell_spmm_pallas`` (the gather
formulation). At 50% block sparsity it does half the dense operations and
reads half the A bytes; on the H100 wide-n layers are bound by
tensor-core operations and n=64 layers by device-memory bytes. The source
says how its design meets that.

Contract (batch folded into rows): ``values [M, ell*bk]``, ``cols
[M/bs, ell]`` int32, ``b [kb, n]``; block-row ``r`` of C is
``sum_e values[r-rows, e-th bk slab] @ b[cols[r, e]*bk : +bk]`` with rows
of ``b`` past ``kb`` read as zero, f32 accumulation, ``alpha * C + beta *
c`` and, with ``transpose_out``, C^T ``[n, M]``. Unlike the TPU kernel,
which needed ``block_size % 128 == 0``, K4 takes any block size that is a
multiple of 16 and ``block_k`` in {16, 32, 64, 128}.

K5 ``csrc/ell_expand.cu`` replaces ``ell_expand_spmm_pallas`` (``:448``)
from the same file. Contract (batch folded): ``values_km [ell*bk, M]``
k-major, ``cols [M/bs, ell]`` int32, ``b [kb, n]``; C ``[M, n]`` or, with
``transpose_out``, exactly ``[n, M]``; rows of ``b`` past ``kb`` read as
zero, f32 accumulation. Where two slots of a block-row name the same block
column, the last slot's slab is the one multiplied, as the TPU kernel's
scatter into a zeroed dense A^T overwrites; K4 sums such slots. A block
column outside ``[0, ceil(kb/bk))`` contributes nothing. The same tile
geometries as K4 are taken.

Both kernels' bf16 path (``block_size % 128 == 0``, ``block_k`` a multiple
of 32, n a multiple of 8, 16-byte aligned tensors) is the Hopper tile of
``csrc/ell_tile.cuh``: TMA loads into a ring of shared-memory stages,
``wgmma``, one persistent block per SM and split-k over slots. Its plan is
:func:`ell_plan`, plain Python that :func:`plan_walk` replays for the CPU
tests; other shapes and f32 take the simple kernels.
"""

from __future__ import annotations

import collections
import functools
import itertools
from typing import Optional

import torch
import torch.nn.functional as F

from ... import _build
from ...utils import trace
from .prune_kernel import DTYPE_CODES
from .spmm24_kernel import H100_SMS, _epilogue_plain, sm_count

BLOCK_KS = (16, 32, 64, 128)
MAX_ELL = 1024  # slots per block-row that K5 lists in shared memory
# (values, cols, b, c, out, ws, M, N, Kb, bs, bk, ell, alpha, beta, tout,
#  dtype, out_dtype, bn, bk_step, stages, splits, ctas, grid, device, stream)
ELL_SPMM = _build.Entry("ell_spmm", "ell_spmm_launch",
                        "pppppp" "iiiiii" "ff" "iii" "iiiiii" "i" "p")
# (values_km, cols, b, out, ws, M, N, Kb, bs, bk, ell, tout, dtype,
#  out_dtype, bn, bk_step, stages, splits, ctas, grid, device, stream)
ELL_EXPAND = _build.Entry("ell_expand", "ell_expand_launch",
                          "ppppp" "iiiiiii" "ii" "iiiiii" "i" "p")

# --- the plan of the Hopper tile (csrc/ell_tile.cuh) ------------------------

TILE_M = 128             # rows of a tile: two consumer warpgroups of 64
TILE_NS = (256, 128, 64)  # columns of a tile, widest first
SMEM_MAX = 232448        # shared memory a block may take on the H100
SMEM_SM = 233472         # shared memory of an SM (1 KB of it kept per block)
MAX_STAGES = 5
MAX_SPLITS = 8
# The cost model that picks a plan (microseconds on one H100 SXM): the
# tensor cores' rate per SM, the rate at which an SM's shared memory feeds
# them (128 bytes a clock), the latency of a stage's loads (a ring of S
# stages takes at least LOAD_US / S a stage), the rate at which an SM's
# epilogue stores a tile of C, the device-memory rate and the second pass
# of split-k. LOAD_US and EPI_BYTES_PER_US fit the tile's device times
# under every plan at the six bench shapes (bench/ell_probe.py --plans;
# PERF.md).
FLOP_PER_US_SM = 989e6 / H100_SMS
SMEM_BYTES_PER_US = 128 * 1755
LOAD_US = 3.5
EPI_BYTES_PER_US = 17e3
BYTES_PER_US = 3.35e6
REDUCE_US = 2.0

EllPlan = collections.namedtuple(
    "EllPlan", "bn bk_step stages splits ctas slots_per_split units grid")


def tile_smem(bn: int, bk_step: int, stages: int) -> int:
    """Shared memory of one block, as ``ellt::Layout::bytes`` lays it out:
    1024 bytes to align, the A and B stages, a bf16 staging tile per
    consumer warpgroup (C or C^T, padded), 24 bytes of barriers and flags a
    stage."""
    staging = max(64 * (bn + 8), bn * (64 + 8))
    return (1024 + stages * (TILE_M * bk_step * 2 + bn * bk_step * 2)
            + 2 * staging * 2 + stages * 24)


@functools.lru_cache(maxsize=1024)
def ell_plan(m: int, n: int, ell: int, bk: int, bs: int,
             sms: int = H100_SMS, widths=TILE_NS, split_counts=None,
             cta_counts=(1, 2)) -> Optional[EllPlan]:
    """The plan of one launch of the Hopper tile for ``values [m, ell*bk]``
    (or k-major), ``b [kb, n]`` and block rows of ``bs``, or None where the
    tile does not apply. The k-step is 64 where ``bk`` allows, else 32, so
    that a stage never spans two slots. Among tile ``widths`` no wider than
    ``n`` needs and split counts (``split_counts``, else 1 to
    ``MAX_SPLITS``) that leave no split empty, it takes the least estimated
    time: waves of units on ``sms`` persistent blocks against the bytes of
    A and C, plus split-k's second pass; ties go to fewer splits, then to
    the wider tile. Stages fill the shared memory of ``cta_counts`` blocks
    per SM (two only for tiles of at most 128 columns), 3 to 5 of them."""
    trace.count("plan_miss")  # the body runs on a cache miss only
    if bs % TILE_M or m % bs or bk % 32 or bk not in BLOCK_KS or n % 8 \
            or n <= 0 or ell <= 0:
        return None
    bks = 64 if bk % 64 == 0 else 32
    m_tiles = m // TILE_M
    best = None
    for bn, ctas in itertools.product(widths, cta_counts):
        if bn > max(64, -(-n // 64) * 64) or (ctas > 1 and bn > 128):
            continue
        n_tiles = -(-n // bn)
        budget = min(SMEM_MAX, SMEM_SM // ctas - 1024)
        stages = min(MAX_STAGES, (budget - tile_smem(bn, bks, 0))
                     // (TILE_M * bks * 2 + bn * bks * 2 + 24))
        for splits in split_counts or range(1, min(ell, MAX_SPLITS) + 1):
            per = -(-ell // splits)
            if (splits - 1) * per >= ell:
                continue  # the last split would be empty
            units = m_tiles * n_tiles * splits
            # a k-step: its products, its operands read from shared memory
            # (A once, B by both consumer warpgroups), or its loads; then
            # the epilogue, which a second block on the SM overlaps
            step_us = max(2 * TILE_M * bn * bks / FLOP_PER_US_SM,
                          (TILE_M + 2 * bn) * bks * 2 / SMEM_BYTES_PER_US,
                          LOAD_US / stages)
            epi_us = TILE_M * bn * (4 if splits > 1 else 2) / EPI_BYTES_PER_US
            steps_us = per * (bk // bks) * step_us
            unit_us = (steps_us + epi_us if ctas == 1
                       else max(steps_us, epi_us))
            est = max(-(-units // (sms * ctas)) * ctas * unit_us,
                      (m * ell * bk * 2 + m * n * 2) / BYTES_PER_US)
            if splits > 1:  # f32 partials written, read by a second pass
                est += REDUCE_US + (8 * splits + 2) * m * n / BYTES_PER_US
            plan = EllPlan(bn, bks, stages, splits, ctas, per, units,
                           min(units, sms * ctas))
            if best is None or (est, splits, ctas, -bn) < best[0]:
                best = ((est, splits, ctas, -bn), plan)
    return best[1] if best else None


def card_plan(index: int, m: int, n: int, ell: int, bk: int, bs: int,
              widths=TILE_NS, split_counts=None) -> Optional[EllPlan]:
    """:func:`ell_plan` on card ``index``."""
    return ell_plan(m, n, ell, bk, bs, sm_count(index), widths, split_counts)


def plan_walk(plan: EllPlan, m: int, n: int, ell: int, bk: int, bs: int,
              live: Optional[torch.Tensor] = None):
    """The k-steps the tile's producer issues, in its order: one list per
    persistent block of ``(m0, n0, split, steps)``, ``steps`` the ``(slot,
    kk)`` of each stage (empty for a unit with nothing to multiply, whose
    consumers store zeros). ``live`` is K5's ``[m/bs, ell]`` mask of
    :func:`live_slots`; K4 takes every slot."""
    n_tiles = -(-n // plan.bn)
    walk = [[] for _ in range(plan.grid)]
    for u in range(plan.units):
        split, t = u % plan.splits, u // plan.splits
        m0, n0 = (t // n_tiles) * TILE_M, (t % n_tiles) * plan.bn
        e0 = split * plan.slots_per_split
        e1 = min(ell, e0 + plan.slots_per_split)
        steps = [(e, kk) for e in range(e0, e1)
                 if live is None or bool(live[m0 // bs, e])
                 for kk in range(0, bk, plan.bk_step)]
        walk[u % plan.grid].append((m0, n0, split, steps))
    return walk


def plan_args(plan: Optional[EllPlan]):
    """The plan as the launch entry points take it; zeros choose the simple
    kernels."""
    if plan is None:
        return (0, 0, 0, 0, 0, 0)
    return (plan.bn, plan.bk_step, plan.stages, plan.splits, plan.ctas,
            plan.grid)


def _plan_for(index, m, n, ell, bk, bs, dtype, tensors, block_n=None,
              splits=None):
    """The tile's plan where dtype and alignment allow it, else None.
    ``block_n`` (one of :data:`TILE_NS`) and ``splits`` (1 to
    :data:`MAX_SPLITS`) force the plan's tile width and split count, the
    knobs the tuner races; a forced plan that the tile cannot take raises
    ``ValueError`` here, before anything is launched."""
    tile_ok = dtype == torch.bfloat16 and not any(
        t is not None and t.data_ptr() % 16 for t in tensors)
    if block_n is None and splits is None:
        return card_plan(index, m, n, ell, bk, bs) if tile_ok else None
    if block_n is not None and block_n not in TILE_NS:
        raise ValueError(f"block_n {block_n} is not one of {TILE_NS}")
    if splits is not None and splits not in range(1, MAX_SPLITS + 1):
        raise ValueError(f"splits {splits} is not in 1..{MAX_SPLITS}")
    plan = None
    if tile_ok:
        plan = card_plan(index, m, n, ell, bk, bs,
                         TILE_NS if block_n is None else (block_n,),
                         None if splits is None else (splits,))
    if plan is None:
        raise ValueError(
            f"no plan of the Hopper tile with block_n={block_n}, "
            f"splits={splits} for values [{m}, {ell}x{bk}], n={n}, block "
            f"rows {bs}, {dtype}{'' if tile_ok else ', misaligned'}")
    return plan


def _workspace(plan, m, n, device) -> Optional[torch.Tensor]:
    """The f32 partials ``[splits, m, n]`` of a split-k plan."""
    if plan is None or plan.splits == 1:
        return None
    return torch.empty((plan.splits, m, n), dtype=torch.float32,
                       device=device)


def ell_spmm_plain(values, cols, b, *, block_size: int, block_k: int,
                   out_dtype: torch.dtype, alpha: float = 1.0,
                   beta: float = 0.0, c: Optional[torch.Tensor] = None,
                   transpose_out: bool = False,
                   block_n: Optional[int] = None,
                   splits: Optional[int] = None) -> torch.Tensor:
    """Plain version of K4: gather each block-row's B slabs, one batched
    f32 product (the plan knobs ``block_n`` and ``splits`` are
    ignored)."""
    bs, bk = block_size, block_k or block_size
    m, ellk = values.shape
    ell = ellk // bk
    kb, n = b.shape
    kblocks = -(-kb // bk)
    bp = F.pad(b.to(torch.float32), (0, 0, 0, kblocks * bk - kb))
    slabs = bp.reshape(kblocks, bk, n)[cols.to(torch.int64)]  # [Mb,ell,bk,n]
    acc = torch.bmm(values.to(torch.float32).reshape(m // bs, bs, ellk),
                    slabs.reshape(m // bs, ellk, n)).reshape(m, n)
    return _epilogue_plain(acc, alpha, beta, c, transpose_out, out_dtype)


def ell_spmm_cuda(values, cols, b, *, block_size: int, block_k: int,
                  out_dtype: torch.dtype, alpha: float = 1.0,
                  beta: float = 0.0, c: Optional[torch.Tensor] = None,
                  transpose_out: bool = False,
                  block_n: Optional[int] = None,
                  splits: Optional[int] = None) -> torch.Tensor:
    """Launch K4. ``values`` and ``b`` are brought to their promoted type;
    ``c`` goes to the kernel as f32. ``block_n`` and ``splits`` force the
    Hopper tile's plan (``None``: :func:`ell_plan`'s pick); a plan it
    cannot take raises ``ValueError`` before the launch."""
    bs, bk = block_size, block_k or block_size
    m, ellk = values.shape
    kb, n = b.shape
    if not (values.is_cuda and cols.is_cuda and b.is_cuda):
        raise ValueError("ell_spmm_cuda needs CUDA tensors")
    if bs <= 0 or bs % 16:
        raise ValueError(f"block_size {bs} must be a positive multiple of 16")
    if bk not in BLOCK_KS:
        raise ValueError(f"block_k {bk} must be one of {BLOCK_KS}")
    if m % bs or ellk % bk:
        raise ValueError(f"values {tuple(values.shape)} do not tile into "
                         f"{bs}x{bk} blocks")
    ell = ellk // bk
    if tuple(cols.shape) != (m // bs, ell):
        raise ValueError(f"col_indices {tuple(cols.shape)} != "
                         f"{(m // bs, ell)}")
    dtype = torch.promote_types(values.dtype, b.dtype)
    if dtype not in DTYPE_CODES or out_dtype not in DTYPE_CODES:
        raise TypeError(f"ell_spmm kernel takes float32/bfloat16, not "
                        f"{dtype} -> {out_dtype}")
    values = values.to(dtype).contiguous()
    b = b.to(dtype).contiguous()
    cols = cols.to(torch.int32).contiguous()
    out_shape = (n, m) if transpose_out else (m, n)
    c32 = None
    if c is not None and beta != 0.0:
        c32 = c.to(torch.float32).reshape(out_shape).contiguous()
    trace.mark("plan")
    index = values.get_device()
    # C is not among the tensors checked for alignment: a fresh allocation
    # is (the caching allocator hands out blocks of 512 bytes)
    plan = _plan_for(index, m, n, ell, bk, bs, dtype,
                     (values, b, c32), block_n, splits)
    trace.mark("alloc")
    out = torch.empty(out_shape, dtype=out_dtype, device=values.device)
    ws = _workspace(plan, m, n, values.device)
    trace.mark("launch")
    ELL_SPMM(index, values.data_ptr(), cols.data_ptr(),
             b.data_ptr(), _build.ptr(c32), out.data_ptr(), _build.ptr(ws),
             m, n, kb, bs, bk, ell, float(alpha),
             float(beta) if c32 is not None else 0.0, int(transpose_out),
             DTYPE_CODES[dtype], DTYPE_CODES[out_dtype], *plan_args(plan))
    ell_spmm_cuda.launches += 1
    return out


ell_spmm_cuda.launches = 0


def live_slots(cols: torch.Tensor, kblocks: int) -> torch.Tensor:
    """``[Mb, ell]`` bool: slots that reach the expand product (in range,
    and no later slot of the block-row names the same block column)."""
    c = cols.to(torch.int64)
    ell = c.shape[-1]
    pos = torch.arange(ell, device=c.device)
    later_same = ((c[:, :, None] == c[:, None, :])
                  & (pos[None, :] > pos[:, None])[None]).any(-1)
    return (c >= 0) & (c < kblocks) & ~later_same


def ell_expand_spmm_plain(values_km, cols, b, *, block_size: int,
                          block_k: int, out_dtype: torch.dtype,
                          transpose_out: bool = False) -> torch.Tensor:
    """Plain version of K5: drop the overridden slots, gather each
    block-row's B slabs, one batched f32 product."""
    bs, bk = block_size, block_k or block_size
    ellk, m = values_km.shape
    ell = ellk // bk
    kb, n = b.shape
    kblocks = -(-kb // bk)
    keep = live_slots(cols, kblocks)
    vals = values_km.to(torch.float32).T.reshape(m // bs, bs, ell, bk)
    vals = vals * keep[:, None, :, None]
    bp = F.pad(b.to(torch.float32), (0, 0, 0, kblocks * bk - kb))
    idx = cols.to(torch.int64).clamp(0, max(kblocks - 1, 0))
    slabs = bp.reshape(kblocks, bk, n)[idx]  # [Mb, ell, bk, n]
    acc = torch.bmm(vals.reshape(m // bs, bs, ellk),
                    slabs.reshape(m // bs, ellk, n)).reshape(m, n)
    return _epilogue_plain(acc, 1.0, 0.0, None, transpose_out, out_dtype)


def ell_expand_spmm_cuda(values_km, cols, b, *, block_size: int,
                         block_k: int, out_dtype: torch.dtype,
                         transpose_out: bool = False) -> torch.Tensor:
    """Launch K5. ``values_km`` and ``b`` are brought to their promoted
    type."""
    bs, bk = block_size, block_k or block_size
    ellk, m = values_km.shape
    kb, n = b.shape
    if not (values_km.is_cuda and cols.is_cuda and b.is_cuda):
        raise ValueError("ell_expand_spmm_cuda needs CUDA tensors")
    if bs <= 0 or bs % 16:
        raise ValueError(f"block_size {bs} must be a positive multiple of 16")
    if bk not in BLOCK_KS:
        raise ValueError(f"block_k {bk} must be one of {BLOCK_KS}")
    if m % bs or ellk % bk:
        raise ValueError(f"values_km {tuple(values_km.shape)} do not tile "
                         f"into {bk}x{bs} blocks")
    ell = ellk // bk
    if tuple(cols.shape) != (m // bs, ell):
        raise ValueError(f"col_indices {tuple(cols.shape)} != "
                         f"{(m // bs, ell)}")
    if ell > MAX_ELL:
        raise ValueError(f"{ell} slots per block-row > {MAX_ELL}")
    dtype = torch.promote_types(values_km.dtype, b.dtype)
    if dtype not in DTYPE_CODES or out_dtype not in DTYPE_CODES:
        raise TypeError(f"ell_expand kernel takes float32/bfloat16, not "
                        f"{dtype} -> {out_dtype}")
    values_km = values_km.to(dtype).contiguous()
    b = b.to(dtype).contiguous()
    cols = cols.to(torch.int32).contiguous()
    out = torch.empty((n, m) if transpose_out else (m, n), dtype=out_dtype,
                      device=values_km.device)
    index = values_km.get_device()
    plan = _plan_for(index, m, n, ell, bk, bs, dtype,
                     (values_km, b, out))
    ws = _workspace(plan, m, n, values_km.device)
    ELL_EXPAND(index, values_km.data_ptr(), cols.data_ptr(), b.data_ptr(),
               out.data_ptr(), _build.ptr(ws), m, n, kb, bs, bk, ell,
               int(transpose_out), DTYPE_CODES[dtype], DTYPE_CODES[out_dtype],
               *plan_args(plan))
    ell_expand_spmm_cuda.launches += 1
    return out


ell_expand_spmm_cuda.launches = 0
