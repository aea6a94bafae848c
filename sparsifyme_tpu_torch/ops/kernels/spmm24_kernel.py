"""Wrappers of kernel K3 (2:4 SpMM), beside their plain PyTorch versions.

K3 ``csrc/spmm24.cu`` replaces
``sparsifyme_tpu/ops/kernels/spmm24_kernel.py:spmm24_pallas``,
``spmm24_pallas_fp`` (the fused alpha/beta/c epilogue and split-half packed
codes) and, through :func:`spmm24_fold_cuda`, ``spmm24_fold_pallas`` (fold=2
planes). At the 2:4 tensor-core rate it is bound by device-memory bytes on
the ResNet-50 layers; the source says how its design (the sparse
tensor-core tile of ``csrc/sp24_tile.cuh``) meets that.

:func:`pick_tile` is the one rule that sizes the tile of a launch, K3's and
K7's. :func:`sparse_tile_dense` is a plain emulation of that tile's operand
path, kept for the CPU tests: the interleaved plane rows it stages, the
metadata words it derives from the codes (:func:`meta_words`, the kernel's
bit operations one for one) and the fragment indexing of ``ldmatrix.trans``
and ``mma.sp``, rebuilding the dense A that the sparse tensor cores
multiply.

Contract: ``C[M, n] = decompress24(v0, v1, codes)[:, :k_logical] @ b`` with
planes ``[k4, M]`` (or split-half packed codes ``[k4/2, M]``), ``b
[k_logical, n]``, f32 accumulation, ``alpha * C + beta * c`` and, with
``transpose_out``, C^T ``[n, M]``. The fold route takes planes ``[2*k4,
M/2]`` and returns row-major C ``[M, n]``. The one scheduling knob of the
``mma_sp`` tile is ``tile``, an index of :data:`SP_TILES` (``None``:
:func:`pick_tile`), which the tuner races; the TPU's
(``block_m/block_n/block_k4``, ``pipeline``, chunking, VMEM budgets) have no
counterpart.

K3 has two designs (:data:`DESIGNS`). ``mma_sp`` is the tile above, on the
planes. ``wgmma_sp`` (:func:`spmm24_wg_cuda`) is the persistent, TMA-fed
``wgmma.sp`` tile of ``csrc/sp24_wg_tile.cuh`` on an operand derived once
from the planes (:func:`pack_wgmma_sp_cuda`, plain version
:func:`pack_wgmma_sp`), planned by :func:`wg_plan`. It takes what
:func:`wg_refusal` lets through: bf16 in and out, no epilogue, C row-major,
unpacked codes, fold 1, M % 128 == 0 and n % 64 == 0. Each wrapper
launches one design; ``spmm_24`` picks between them, in
``ops.sparse24.spmm24_design`` alone, and never falls back from one to the
other. On large products bound by the tensor cores (:func:`wg_tall`: M %
256 == 0) :func:`wg_plan` may give the tile units of 256 rows instead of
128 (:class:`WgTallPlan`), walked in bands of m-tiles (:func:`wg_band`) so
that the blocks in flight share B's column strips: the same products in
the same k-order, so the same C bit for bit.
"""

from __future__ import annotations

import functools
from typing import List, NamedTuple, Optional, Tuple

import torch

from ... import _build
from ...utils import trace
from .prune_kernel import DTYPE_CODES

# Tiles (rows of C, columns of C) of the sparse tensor-core fast path, in
# the order of the ``tile`` argument of spmm24_launch and ring24_launch.
SP_TILES = ((256, 128), (128, 128), (128, 64), (64, 64))
H100_SMS = 132
# (v0, v1, codes, b, c, out, M, N, K, K4, alpha, beta, tout, packed, fold,
#  dtype, out_dtype, tile, device, stream)
SPMM24 = _build.Entry("spmm24", "spmm24_launch",
                      "pppppp" "iiii" "ff" "iiiiii" "i" "p")


def pick_tile(m: int, n: int, k: int, fold: int = 1,
              sms: int = H100_SMS) -> int:
    """Index into :data:`SP_TILES` of the tile a launch of ``fold`` halves
    of an ``m x n`` output over depth ``k`` takes: the largest whose grid
    gives every SM a block, else the smallest. Tiles wider than ``n`` are
    skipped once ``n`` exceeds 64. The 256-row tile (one block per SM)
    also needs eight k-steps or more (``k >= 512``) to reuse its B tile
    over, and a last wave at least half full.

    One block per SM, not the two that fit: a larger tile re-reads B and A
    fewer times, so it wins as long as no SM idles (every tile timed at
    each of these shapes on one H100 by ``bench/sp24_probe.py``; numbers in
    PERF.md)."""
    for i, (bm, bn) in enumerate(SP_TILES):
        blocks = -(-m // bm) * -(-n // bn) * fold
        if bn > max(n, 64) or blocks < sms:
            continue
        if bm == 256 and (k < 512 or 0 < blocks % sms < sms // 2):
            continue
        return i
    return len(SP_TILES) - 1


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def card_tile(index: int, m: int, n: int, k: int, fold: int = 1) -> int:
    """:func:`pick_tile` on card ``index``."""
    return pick_tile(m, n, k, fold, sm_count(index))


# --- plain emulation of the sparse tile's operand path (CPU tests) --------

def byte_perm(x: torch.Tensor, y: torch.Tensor, sel: int) -> torch.Tensor:
    """CUDA ``__byte_perm(x, y, sel)`` on int64 tensors of 32-bit words."""
    src = ([(x >> (8 * i)) & 0xFF for i in range(4)]
           + [(y >> (8 * i)) & 0xFF for i in range(4)])
    out = torch.zeros_like(x)
    for i in range(4):
        out |= src[(sel >> (4 * i)) & 7] << (8 * i)
    return out


def nibbles16(x: torch.Tensor) -> torch.Tensor:
    """The kernel's ``nibbles16``: four code bytes (i0*4+i1) to 16 metadata
    bits, nibble ``i0 | i1 << 2`` per group; a zero byte becomes (0, 1)."""
    i1 = x & 0x03030303
    i0 = (x >> 2) & 0x03030303
    z = ((i1 | (i1 >> 1)) & 0x01010101) ^ 0x01010101
    n = i0 | (i1 << 2) | (z << 2)
    n = (n | (n >> 4)) & 0x00FF00FF
    return (n | (n >> 8)) & 0xFFFF


def transpose4(x):
    """The kernel's ``transpose4``: ``r[i]`` byte j = ``x[j]`` byte i."""
    t0, t1 = byte_perm(x[0], x[1], 0x5140), byte_perm(x[2], x[3], 0x5140)
    t2, t3 = byte_perm(x[0], x[1], 0x7362), byte_perm(x[2], x[3], 0x7362)
    return (byte_perm(t0, t1, 0x5410), byte_perm(t0, t1, 0x7632),
            byte_perm(t2, t3, 0x5410), byte_perm(t2, t3, 0x7632))


def staged_codes(codes: torch.Tensor, k4: int, packed: bool,
                 kt: int) -> torch.Tensor:
    """The code bytes stage ``kt`` lands in shared memory, ``[16, M]``
    int64: group ``16kt + gl`` per row (for split-half packed codes the
    byte of row ``g - k4/2`` past the half), zero past the planes' groups."""
    m = codes.shape[-1]
    out = torch.zeros((16, m), dtype=torch.int64)
    for gl in range(16):
        g = kt * 16 + gl
        if g < k4:
            row = g - k4 // 2 if packed and g >= k4 // 2 else g
            out[gl] = codes[row].to(torch.int64)
    return out


def meta_words(es: torch.Tensor, k4: int, packed: bool,
               kt: int) -> torch.Tensor:
    """The kernel's ``build_meta`` on the staged code bytes ``es [16, M]``
    (M a multiple of 16): metadata words ``[2 (k-step), M/16, 8 (gid),
    2 (h)]``. Item (half, mf, h, gq) reads 32-bit words of four rows for
    groups ``8*half + 4h + j``, rows ``mf*16 + gq*4`` and those + 8,
    transposes them and writes gid ``gq*4 + i``."""
    mf_n = es.shape[1] // 16
    words = torch.zeros((2, mf_n, 8, 2), dtype=torch.int64)
    for hf in range(2):
        for h in range(2):
            lo_hi = []
            for off in (0, 8):
                xs = []
                for j in range(4):
                    gl = hf * 8 + 4 * h + j
                    # [mf, gq, i]: rows mf*16 + off + gq*4 + i
                    rows = es[gl].reshape(mf_n, 2, 2, 4)[:, off // 8]
                    w = sum(rows[..., i] << (8 * i) for i in range(4))
                    if packed:
                        sh = 4 if kt * 16 + gl >= k4 // 2 else 0
                        w = (w >> sh) & 0x0F0F0F0F
                    xs.append(w)  # [mf, gq]
                lo_hi.append(transpose4(xs))
            for i in range(4):
                wd = nibbles16(lo_hi[0][i]) | (nibbles16(lo_hi[1][i]) << 16)
                words[hf, :, i::4, h] = wd  # gid = gq*4 + i
    return words


def sparse_tile_dense(v0: torch.Tensor, v1: torch.Tensor,
                      codes: torch.Tensor, *, packed: bool = False,
                      fold: int = 1) -> torch.Tensor:
    """Dense ``A [fold*M, 64*KT]`` as the sparse tile feeds it to ``mma.sp``
    (planes ``[fold*k4, M]``, M a multiple of 16; fold=2 halves give rows
    ``2j + z``). Per stage and 32-deep k-step: ``ldmatrix.x4.trans`` hands
    thread t, from matrix q, the staged interleaved rows (compressed
    columns) ``8*(q>>1) + 2*(t%4)`` and +1 at plane column ``mf*16 +
    8*(q&1) + t//4``; ``mma.sp`` reads register q of thread t as A row
    ``t//4 + 8*(q&1)``, compressed columns ``2*(t%4) + 8*(q>>1)`` and +1.
    Compressed column c of row r is group ``j = c//2``; its two indices
    come from the word of thread (gid ``r % 8``, ``tig & 1 == j // 4``),
    bits ``16*(r // 8) + 4*(j % 4) + 2*(c % 2)``, and place the value at
    k ``4j + idx`` of the k-step."""
    fk4, m = v0.shape
    k4 = fk4 // fold
    kt_n = -(-k4 // 16)
    mf_n = m // 16
    t = torch.arange(32)[:, None, None]
    q = torch.arange(4)[None, :, None]
    lh = torch.arange(2)[None, None, :]
    c_st = (8 * (q >> 1) + 2 * (t & 3) + lh).expand(32, 4, 2).reshape(-1)
    r_st = (8 * (q & 1) + (t >> 2)).expand(32, 4, 2).reshape(-1)
    r_fr = ((t >> 2) + 8 * (q & 1)).expand(32, 4, 2).reshape(-1)
    c_fr = (2 * (t & 3) + 8 * (q >> 1) + lh).expand(32, 4, 2).reshape(-1)
    j = c_fr // 2
    shift = 16 * (r_fr // 8) + 4 * (j % 4) + 2 * (c_fr % 2)
    dense = torch.zeros((fold, m, 64 * kt_n), dtype=torch.float32)
    for z in range(fold):
        planes = [p[z * k4:(z + 1) * k4].to(torch.float32) for p in (v0, v1)]
        pc = codes if packed else codes[z * k4:(z + 1) * k4]
        for kt in range(kt_n):
            a_s = torch.zeros((32, m), dtype=torch.float32)
            for gl in range(min(16, k4 - kt * 16)):
                a_s[2 * gl] = planes[0][kt * 16 + gl]
                a_s[2 * gl + 1] = planes[1][kt * 16 + gl]
            words = meta_words(staged_codes(pc, k4, packed, kt), k4, packed,
                               kt)
            for hf in range(2):
                for mf in range(mf_n):
                    val = a_s[hf * 16 + c_st, mf * 16 + r_st]
                    word = words[hf, mf, r_fr % 8, j // 4]
                    idx = (word >> shift) & 3
                    k = kt * 64 + hf * 32 + 4 * j + idx
                    dense[z].index_put_((mf * 16 + r_fr, k), val,
                                        accumulate=True)
    if fold == 1:
        return dense[0]
    return dense.permute(1, 0, 2).reshape(fold * m, 64 * kt_n)


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
                 transpose_out: bool = False, packed_codes: bool = False,
                 tile: Optional[int] = None) -> torch.Tensor:
    """Plain version of K3: decompress, then an f32 product (``tile``, a
    scheduling knob of the kernel, is ignored)."""
    if packed_codes:
        codes = unpack_codes_fp(codes, v0.shape[0])
    a_t = expand_planes(v0, v1, codes)[:k_logical].to(torch.float32)
    acc = a_t.T @ b.to(torch.float32)
    return _epilogue_plain(acc, alpha, beta, c, transpose_out, out_dtype)


def spmm24_fold_plain(v0, v1, codes, b, *, k_logical: int,
                      out_dtype: torch.dtype, alpha: float = 1.0,
                      beta: float = 0.0, c: Optional[torch.Tensor] = None,
                      tile: Optional[int] = None) -> torch.Tensor:
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
            transpose_out, packed_codes, fold, tile, what) -> torch.Tensor:
    k4, m = v0.shape
    if tile is not None and tile not in range(len(SP_TILES)):
        raise ValueError(f"tile {tile} is not an index of SP_TILES "
                         f"(0..{len(SP_TILES) - 1})")
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
    trace.mark("plan")
    index = v0.get_device()
    if tile is None:
        tile = card_tile(index, m, n, k_logical, fold)
    trace.mark("alloc")
    out = torch.empty(out_shape, dtype=out_dtype, device=v0.device)
    trace.mark("launch")
    SPMM24(index, v0.data_ptr(), v1.data_ptr(), codes.data_ptr(),
           b.data_ptr(), _build.ptr(c32), out.data_ptr(), m, n, k_logical,
           k4, float(alpha), float(beta) if c32 is not None else 0.0,
           int(transpose_out), int(packed_codes), fold, DTYPE_CODES[dtype],
           DTYPE_CODES[out_dtype], tile)
    return out


def spmm24_cuda(v0, v1, codes, b, *, k_logical: int,
                out_dtype: torch.dtype, alpha: float = 1.0,
                beta: float = 0.0, c: Optional[torch.Tensor] = None,
                transpose_out: bool = False, packed_codes: bool = False,
                tile: Optional[int] = None) -> torch.Tensor:
    """Launch K3's ``mma_sp`` tile on the planes. Planes and ``b`` are
    brought to their promoted type (the kernel multiplies like types);
    ``c`` goes to the kernel as f32. ``tile`` forces an index of
    :data:`SP_TILES` on the sparse tile's fast path (``None``:
    :func:`pick_tile`); the simple kernels ignore it."""
    out = _launch(v0, v1, codes, b, k_logical=k_logical, out_dtype=out_dtype,
                  alpha=alpha, beta=beta, c=c, transpose_out=transpose_out,
                  packed_codes=packed_codes, fold=1, tile=tile,
                  what="spmm24_cuda")
    spmm24_cuda.launches += 1
    return out


spmm24_cuda.launches = 0


def spmm24_fold_cuda(v0, v1, codes, b, *, k_logical: int,
                     out_dtype: torch.dtype, alpha: float = 1.0,
                     beta: float = 0.0, c: Optional[torch.Tensor] = None,
                     tile: Optional[int] = None) -> torch.Tensor:
    """Launch K3 on fold=2 planes ``[2*k4, M/2]``; returns row-major
    ``C [M, n]``. ``tile`` as in :func:`spmm24_cuda`."""
    _check_fold(v0, k_logical)
    out = _launch(v0, v1, codes, b, k_logical=k_logical, out_dtype=out_dtype,
                  alpha=alpha, beta=beta, c=c, transpose_out=False,
                  packed_codes=False, fold=2, tile=tile,
                  what="spmm24_fold_cuda")
    spmm24_fold_cuda.launches += 1
    return out


spmm24_fold_cuda.launches = 0


# --- K3's wgmma_sp route -----------------------------------------------------

DESIGNS = ("wgmma_sp", "mma_sp")  # K3's tiles, as spmm_24's design names them
WG_BM = 128  # rows of a wgmma_sp tile: two warpgroups of 64
WG_TALL_BM = 256  # rows of its tall unit: two tiles of 128, one a warpgroup
WG_KS = 64  # logical k of one of its k-steps
WG_WORDS = 2304  # 32-bit words of a tile's k-step: 8 KB of A, 1 KB of meta
# (a, b, out, ws, M, N, K, KTP, bn, splits, kps, grid, device, stream)
SPMM24_WG = _build.Entry("spmm24", "spmm24_wg_launch",
                         "pppp" "iiii" "iiii" "i" "p")
# (a, b, out, ws, M, N, K, KTP, bn, splits, kps, band, grid, device, stream)
SPMM24_WG256 = _build.Entry("spmm24", "spmm24_wg256_launch",
                            "pppp" "iiii" "iiii" "ii" "p")
# (v0, v1, codes, out, M, K4, KTP, device, stream)
SPMM24_PACK = _build.Entry("spmm24", "spmm24_pack_launch",
                           "pppp" "iii" "i" "p")


class WgPlan(NamedTuple):
    """A launch of the ``wgmma_sp`` tile: its width, split count, k-steps a
    split, work units (m-tile, n-tile, split) and persistent blocks. Its
    units are 128 rows, the n-tiles of an m-tile adjacent (``band`` 0)."""
    bn: int
    splits: int
    kps: int
    units: int
    grid: int

    rows = WG_BM
    band = 0


class WgTallPlan(NamedTuple):
    """A launch of the tile's 256-row unit: :class:`WgPlan`'s fields, then
    the m-tiles (of 256 rows) of a band (:func:`wg_band`), which the
    units walk m-tile first, then n-tile."""
    bn: int
    splits: int
    kps: int
    units: int
    grid: int
    band: int

    rows = WG_TALL_BM


# A k-step of the wgmma_sp tile on one SM (microseconds, by tile width):
# its time under the one-split plan at D (units_probe --plans, PERF.md)
WG_STEP_US = {64: 0.36, 128: 0.43}
# The same of the 256-row unit: four waves of one-split units at k 8192
# (bench/wg_tall.py --steps, PERF.md)
WG256_STEP_US = {64: 0.35, 128: 0.46}
# m-tiles of 256 rows a band of its walk: at MiMo's q, o, gate_up and down
# every band from 3 to 16 is within 5% of the best (bench/wg_tall.py,
# PERF.md), band 1 (no band) 25-35% slower
WG_BAND = 8


def _wg_shape(m: int, n: int, k: int) -> None:
    if m % WG_BM or n % 64 or m <= 0 or n <= 0 or k <= 0:
        raise ValueError(f"the wgmma_sp tile needs M % {WG_BM} == 0 and "
                         f"n % 64 == 0, got {m} x {n} x {k}")


def wg_tall(m: int, n: int, k: int, sms: int = H100_SMS) -> bool:
    """Whether the 256-row unit may take ``m x n x k``: M a multiple of 256
    and the product bound by the tensor cores, its kept products at 989
    TFLOP/s (``sms`` SMs) taking longer than the packed A (1.125 B a
    logical element), B and C at 3.35 TB/s."""
    from . import ell_kernel as ellk  # it imports this module

    return m % WG_TALL_BM == 0 and \
        m * k * n / (ellk.FLOP_PER_US_SM * sms) > \
        (1.125 * m * k + 2 * k * n + 2 * m * n) / ellk.BYTES_PER_US


def wg_band(m: int) -> int:
    """The m-tiles (of 256 rows) of a band of the tall unit's walk:
    :data:`WG_BAND`, or every m-tile where there are fewer."""
    return min(WG_BAND, m // WG_TALL_BM)


def wg_plan(m: int, n: int, k: int, sms: int = H100_SMS,
            extra_bytes: float = 0.0, widths: tuple = (),
            tall: bool = True) -> WgPlan:
    """The plan of the ``wgmma_sp`` tile at ``m x n x k`` on ``sms`` SMs:
    128 columns where n allows, else 64 (``widths``: the column counts to
    choose among instead, where n allows them); units of 128 rows or, where
    ``tall`` (the caller's kernel has it) and :func:`wg_tall` allow, of
    256 (:class:`WgTallPlan`); among split counts up to
    ``ell_kernel.MAX_SPLITS`` that leave no split empty, the least
    estimated time: waves of units on ``sms`` persistent blocks, each unit
    its k-steps (:data:`WG_STEP_US`, :data:`WG256_STEP_US`) and its
    epilogue, against the bytes (A, B and C, plus ``extra_bytes``: K7's
    step adds its f32 accumulator's), plus split-k's second pass
    (``ell_kernel.ell_plan``'s constants); ties go to fewer splits, then to
    the earlier width, then to 128 rows."""
    from . import ell_kernel as ellk  # it imports this module

    _wg_shape(m, n, k)
    kt = -(-k // WG_KS)
    floor_us = (1.25 * m * k + 2 * k * n + 2 * m * n + extra_bytes) \
        / ellk.BYTES_PER_US
    best = None
    bns = [w for w in widths if n % w == 0] or [128 if n % 128 == 0 else 64]
    heights = (WG_BM, WG_TALL_BM) if tall and wg_tall(m, n, k, sms) \
        else (WG_BM,)
    for splits, bn, rows in [
            (splits, bn, rows)
            for splits in range(1, min(kt, ellk.MAX_SPLITS) + 1)
            for bn in bns for rows in heights]:
        tiles = (m // rows) * (n // bn)
        kps = -(-kt // splits)
        if (splits - 1) * kps >= kt:
            continue  # the last split would be empty
        units = tiles * splits
        step_us = (WG_STEP_US if rows == WG_BM else WG256_STEP_US)[bn]
        epi_us = rows * bn * (4 if splits > 1 else 2) / ellk.EPI_BYTES_PER_US
        est = max(-(-units // sms) * (kps * step_us + epi_us), floor_us)
        if splits > 1:  # f32 partials written, read by the second pass
            est += ellk.REDUCE_US + (8 * splits + 2) * m * n \
                / ellk.BYTES_PER_US
        if best is None or est < best[0]:
            best = (est, _wg_plan_of(m, bn, splits, kps, units,
                                     min(units, sms), rows))
    return best[1]


def _wg_plan_of(m: int, bn: int, splits: int, kps: int, units: int,
                grid: int, rows: int) -> WgPlan:
    if rows == WG_BM:
        return WgPlan(bn, splits, kps, units, grid)
    return WgTallPlan(bn, splits, kps, units, grid,
                      wg_band(m))


def wg_forced_plan(m: int, n: int, k: int, bn: int, splits: int,
                   sms: int = H100_SMS, rows: int = WG_BM) -> WgPlan:
    """The plan of ``bn`` columns, ``splits`` splits and units of ``rows``
    rows (the tuner's ``--full`` candidates); raises where the tile cannot
    take it."""
    _wg_shape(m, n, k)
    kt = -(-k // WG_KS)
    kps = -(-kt // max(splits, 1))
    if bn not in (64, 128) or n % bn or splits < 1 or \
            (splits - 1) * kps >= kt or rows not in (WG_BM, WG_TALL_BM) or \
            m % rows:
        raise ValueError(f"the wgmma_sp tile cannot take {bn} columns, "
                         f"{splits} splits and {rows} rows at {m} x {n} x "
                         f"{k}")
    units = (m // rows) * (n // bn) * splits
    return _wg_plan_of(m, bn, splits, kps, units, min(units, sms), rows)


def wg_walk(plan: WgPlan, m: int, n: int, k: int
            ) -> List[List[Tuple[int, int, int, List[int]]]]:
    """The units each persistent block of the ``wgmma_sp`` tile takes, in
    its order: one list per block of ``(m_tile, n_tile, split, k-steps)``,
    m-tiles of ``plan.rows`` rows, the kernel's own loops
    (``sp24w::Unit``) replayed: the n-tiles of an m-tile adjacent or, with
    a ``band``, bands of that many m-tiles, m-tile first."""
    kt = -(-k // WG_KS)
    n_tiles, m_tiles, band = n // plan.bn, m // plan.rows, plan.band
    out = []
    for blk in range(plan.grid):
        walk = []
        for u in range(blk, plan.units, plan.grid):
            split, t = u % plan.splits, u // plan.splits
            if band:
                first = t // (band * n_tiles) * band
                r, g = t - first * n_tiles, min(band, m_tiles - first)
                m_tile, n_tile = first + r % g, r // g
            else:
                m_tile, n_tile = t // n_tiles, t % n_tiles
            k0 = split * plan.kps
            walk.append((m_tile, n_tile, split,
                         list(range(k0, min(kt, k0 + plan.kps)))))
        out.append(walk)
    return out


@functools.lru_cache(maxsize=1024)
def card_wg_plan(index: int, m: int, n: int, k: int,
                 bn: Optional[int] = None,
                 splits: Optional[int] = None) -> WgPlan:
    """:func:`wg_plan` on card ``index`` or, with ``bn`` or ``splits``
    given, :func:`wg_forced_plan` (the other from :func:`wg_plan`), once per
    shape and card."""
    trace.count("plan_miss")  # the body runs on a cache miss only
    sms = sm_count(index)
    if bn is None and splits is None:
        return wg_plan(m, n, k, sms)
    pick = wg_plan(m, n, k, sms)
    return wg_forced_plan(m, n, k, bn or pick.bn, splits or pick.splits, sms,
                          pick.rows)


def sw64_offset(r: int, c: int) -> int:
    """Byte offset of compressed column ``c`` of row ``r`` in a ``128 x
    32`` bf16 tile of the ``wgmma_sp`` operand: 64-byte rows, 16-byte chunk
    ``c // 8`` at ``c // 8 ^ ((r >> 1) & 3)``, the 64-byte swizzle that
    ``wgmma`` reads K-major A in."""
    return r * 64 + (((c // 8) ^ ((r >> 1) & 3)) << 4) + (c % 8) * 2


def _to_int32(words: torch.Tensor) -> torch.Tensor:
    """uint32 values held in int64, as int32 bits."""
    return ((words + 2 ** 31) % 2 ** 32 - 2 ** 31).to(torch.int32)


def _swizzle_index(dev) -> torch.Tensor:
    """``[128, 4]``: chunk ``p ^ ((row >> 1) & 3)`` of each row and place
    ``p`` (the 64-byte swizzle, its own inverse)."""
    r = torch.arange(WG_BM, device=dev)
    return torch.arange(4, device=dev)[None, :] ^ ((r[:, None] >> 1) & 3)


def pack_wgmma_sp(v0, v1, codes) -> torch.Tensor:
    """The ``wgmma_sp`` tile's operand, derived once from the planes ``v0,
    v1, codes [k4, M]`` (M a multiple of 128), on their device: ``[ktp, M /
    128, 2304]`` int32, ``ktp = ceil(k4 / 16)`` 64-deep k-steps, one
    contiguous 9 KB block per k-step and 128-row tile that one bulk copy
    moves into a stage (the tiles of one k-step side by side, as the
    persistent blocks read them at once):

    * words 0-2047: the compressed values, K-major, 128 rows of 32 bf16
      (compressed column ``2g`` = ``v0[g]``, ``2g + 1`` = ``v1[g]``, zero
      past k4), at :func:`sw64_offset`;
    * words 2048-2303: the metadata words in the order the threads of a
      warpgroup hand them to ``wgmma.sp``, ``[warpgroup, k32 half, warp,
      gid, h]``: rows ``64 wg + 16 warp + gid`` (bits 0-15) and that row +
      8 (bits 16-31), groups ``16 kt + 8 half + 4h + j`` at nibble ``j`` =
      ``i0 | i1 << 2`` (a code with ``i1 == 0``, only the zero padding,
      becomes (0, 1), as :func:`nibbles16` makes it).

    The plain version of :func:`pack_wgmma_sp_cuda` (int64 intermediates:
    CPU tensors and checks only); :func:`unpack_wgmma_sp` inverts it."""
    k4, m = v0.shape
    if m % WG_BM:
        raise ValueError(f"pack_wgmma_sp needs M % {WG_BM} == 0, got {m}")
    ktp = -(-k4 // 16)
    g = 16 * ktp
    mt = m // WG_BM
    dev = v0.device
    vals = torch.zeros((g, 2, m), dtype=v0.dtype, device=dev)
    vals[:k4, 0] = v0
    vals[:k4, 1] = v1
    # [kt, tile, row, chunk, 8]: chunk c of a row lands at c ^ ((row >> 1) & 3)
    vals = vals.reshape(ktp, 4, 8, mt, WG_BM).permute(0, 3, 4, 1, 2)
    r = torch.arange(WG_BM, device=dev)
    vals = vals[:, :, r[:, None], _swizzle_index(dev)]
    values = vals.contiguous().view(torch.int32).reshape(ktp, mt, 2048)
    c = torch.zeros((g, m), dtype=torch.int64, device=dev)
    c[:k4] = codes.to(torch.int64)
    i1 = c & 3
    nib = ((c >> 2) & 3) | (torch.where(i1 == 0, 1, i1) << 2)
    # groups (kt, half, h, j) by rows (tile, warpgroup, warp, +8, gid)
    nib = nib.reshape(ktp, 2, 2, 4, mt, 2, 4, 2, 8)
    j = torch.arange(4, device=dev).view(1, 1, 1, 4, 1, 1, 1, 1, 1)
    hi = torch.arange(2, device=dev).view(1, 1, 1, 1, 1, 1, 1, 2, 1)
    words = (nib << (4 * j + 16 * hi)).sum(dim=(3, 7))
    meta = _to_int32(words.permute(0, 3, 4, 1, 5, 6, 2).reshape(ktp, mt, 256))
    return torch.cat([values, meta], dim=2).contiguous()


def unpack_wgmma_sp(packed: torch.Tensor, k4: int
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The planes ``(v0, v1, codes) [k4, M]`` back from
    :func:`pack_wgmma_sp`'s operand, bit for bit for codes with ``i0 <
    i1`` (every code K2 writes)."""
    ktp, mt = packed.shape[:2]
    m, g = mt * WG_BM, 16 * ktp
    dev = packed.device
    vals = packed[:, :, :2048].contiguous().view(torch.bfloat16)
    vals = vals.reshape(ktp, mt, WG_BM, 4, 8)
    r = torch.arange(WG_BM, device=dev)
    vals = vals[:, :, r[:, None], _swizzle_index(dev)]  # [kt, tile, row, ..]
    vals = vals.permute(0, 3, 4, 1, 2).reshape(g, 2, m)
    w = (packed[:, :, 2048:].to(torch.int64) & 0xFFFFFFFF).reshape(
        ktp, mt, 2, 2, 4, 8, 2)
    sh = (16 * torch.arange(2, device=dev)[:, None]
          + 4 * torch.arange(4, device=dev)[None, :])
    nib = (w[..., None, None] >> sh) & 15  # [..., h, +8, j]
    nib = nib.permute(0, 3, 6, 8, 1, 2, 4, 7, 5).reshape(g, m)
    codes = ((nib & 3) * 4 + (nib >> 2))[:k4].to(torch.uint8)
    return (vals[:k4, 0].contiguous(), vals[:k4, 1].contiguous(),
            codes.contiguous())


def pack_wgmma_sp_cuda(v0, v1, codes) -> torch.Tensor:
    """Launch the pack kernel (``csrc/spmm24.cu``: ``wg_pack_kernel``): the
    int32 words of :func:`pack_wgmma_sp`, bit for bit, in one pass over the
    planes (bf16 ``v0``, ``v1``, uint8 ``codes``, ``[k4, M]`` on one card,
    M a multiple of 128)."""
    if not v0.is_cuda or any(t.device != v0.device for t in (v1, codes)):
        raise ValueError("pack_wgmma_sp_cuda needs the planes on one card")
    if v0.dtype != torch.bfloat16 or v1.dtype != torch.bfloat16 or \
            codes.dtype != torch.uint8:
        raise ValueError("pack_wgmma_sp_cuda takes bf16 planes and uint8 "
                         f"codes, not {v0.dtype}, {v1.dtype}, {codes.dtype}")
    k4, m = v0.shape
    if v1.shape != v0.shape or codes.shape != v0.shape or m % WG_BM or \
            k4 <= 0:
        raise ValueError(f"pack_wgmma_sp_cuda needs planes [k4, M] with M % "
                         f"{WG_BM} == 0, got {tuple(v0.shape)}, "
                         f"{tuple(v1.shape)}, {tuple(codes.shape)}")
    v0, v1, codes = (t.contiguous() for t in (v0, v1, codes))
    ktp = -(-k4 // 16)
    trace.mark("alloc")
    out = torch.empty((ktp, m // WG_BM, WG_WORDS), dtype=torch.int32,
                      device=v0.device)
    trace.mark("launch")
    SPMM24_PACK(v0.get_device(), v0.data_ptr(), v1.data_ptr(),
                codes.data_ptr(), out.data_ptr(), m, k4, ktp)
    pack_wgmma_sp_cuda.launches += 1
    return out


pack_wgmma_sp_cuda.launches = 0


def wg_dense(packed: torch.Tensor) -> torch.Tensor:
    """Dense ``A^T [64 ktp, M]`` f32 as the ``wgmma_sp`` tile reads its
    operand, decoded from the packed words alone: each compressed value
    from its swizzled place, put at the k that its metadata nibble names
    (``i0`` for compressed column ``2g``, ``i1`` for ``2g + 1``)."""
    ktp, mt = packed.shape[:2]
    dev = packed.device
    vals = packed[:, :, :2048].contiguous().view(torch.bfloat16).reshape(
        ktp, mt, WG_BM, 4, 8)
    r = torch.arange(WG_BM, device=dev)
    vals = vals[:, :, r[:, None], _swizzle_index(dev)]  # logical chunks
    vals = vals.reshape(ktp, mt, WG_BM, 16, 2).to(torch.float32)
    w = (packed[:, :, 2048:].to(torch.int64) & 0xFFFFFFFF).reshape(
        ktp, mt, 2, 2, 4, 8, 2)  # [kt, tile, wg, half, warp, gid, h]
    sh = (16 * torch.arange(2, device=dev)[:, None]
          + 4 * torch.arange(4, device=dev)[None, :])
    nib = (w[..., None, None] >> sh) & 15  # [..., h, +8, j]
    # rows (wg, warp, +8, gid), groups (half, h, j)
    nib = nib.permute(0, 1, 2, 4, 7, 5, 3, 6, 8).reshape(ktp, mt, WG_BM, 16)
    q = torch.arange(4, device=dev)
    dense = (vals[..., 0, None] * ((nib & 3)[..., None] == q)
             + vals[..., 1, None] * ((nib >> 2)[..., None] == q))
    # [kt, tile, row, group, 4] -> [kt, group, 4, tile, row]
    return dense.permute(0, 3, 4, 1, 2).reshape(64 * ktp, mt * WG_BM)


def wg_shape(rows: int, n: int, dtype: torch.dtype) -> bool:
    """A shape the ``wgmma_sp`` route takes: bf16, ``rows`` (M, the batch
    folded in) a multiple of 128 and n of 64."""
    return dtype == torch.bfloat16 and rows % WG_BM == 0 and n % 64 == 0


def wg_refusal(*, fold: int, planes_dtype: torch.dtype, b: torch.Tensor,
               out_dtype: torch.dtype, alpha: float, beta: float,
               c: Optional[torch.Tensor], transpose_out: bool,
               packed_codes: bool, tile: Optional[int], m: int
               ) -> Optional[str]:
    """Why the ``wgmma_sp`` route cannot take a call (``None``: it can):
    the rule by which ``spmm_24`` picks K3's tile
    (``ops.sparse24.spmm24_design``). The route's epilogue writes bf16 C
    row-major, nothing else."""
    if fold != 1:
        return "fold=2 planes"
    if tile is not None:
        return "tile indexes the mma_sp tile"
    if transpose_out:
        return "transpose_out"
    if packed_codes:
        return "packed codes"
    if alpha != 1.0 or (c is not None and beta != 0.0):
        return "an alpha/beta/c epilogue"
    if planes_dtype != torch.bfloat16 or b.dtype != torch.bfloat16 or \
            out_dtype != torch.bfloat16:
        return (f"{planes_dtype} planes, {b.dtype} b, {out_dtype} out "
                "(bf16 only)")
    if m % WG_BM or b.shape[-1] % 64:
        return f"M {m} % {WG_BM} or n {b.shape[-1]} % 64"
    if b.is_contiguous() and b.data_ptr() % 16:
        return "b is not 16-byte aligned"
    return None


def _check_wg(wg, b, m: int, k_logical: int, what: str
              ) -> Tuple[int, int]:
    """``(k-steps, n)`` of a call of either wg route, after the shape
    checks both make: ``wg`` is the packed operand of ``m`` rows, ``b``
    ``[k_logical, n]`` within its k-steps."""
    if wg.dim() != 3 or b.dim() != 2:
        raise ValueError(f"{what}: wg {tuple(wg.shape)}, b {tuple(b.shape)}")
    ktp, mt, words = wg.shape
    kb, n = b.shape
    if words != WG_WORDS or mt * WG_BM != m or kb != k_logical or \
            not 0 < k_logical <= WG_KS * ktp:
        raise ValueError(f"{what}: wg {tuple(wg.shape)} is not "
                         f"pack_wgmma_sp's operand of {m} rows for b "
                         f"{tuple(b.shape)} and k_logical {k_logical}")
    return ktp, n


def spmm24_wg_plain(wg, b, *, m: int, k_logical: int,
                    out_dtype: torch.dtype, block_n: Optional[int] = None,
                    splits: Optional[int] = None) -> torch.Tensor:
    """Plain version of :func:`spmm24_wg_cuda`: the packed operand decoded
    (:func:`wg_dense`, never the planes), then an f32 product (the plan
    knobs are ignored)."""
    _check_wg(wg, b, m, k_logical, "spmm24_wg_plain")
    a_t = wg_dense(wg)[:k_logical]
    return (a_t.T @ b.to(torch.float32)).to(out_dtype)


def spmm24_wg_cuda(wg, b, *, m: int, k_logical: int,
                   out_dtype: torch.dtype, block_n: Optional[int] = None,
                   splits: Optional[int] = None) -> torch.Tensor:
    """Launch K3's ``wgmma_sp`` route: ``C [m, n] bf16 = A @ b`` with A the
    packed operand ``wg`` (:func:`pack_wgmma_sp_cuda`) and ``b [k_logical,
    n]`` bf16 on its card, on the current stream, under :func:`wg_plan`'s
    plan (once per shape and card), or the one of ``block_n`` columns and
    ``splits`` splits. Raises on anything the tile does not take. Its
    checks are kept cheap: the host's time to queue a call
    (``enqueue_ms``) must stay under the kernel's."""
    ktp, n = _check_wg(wg, b, m, k_logical, "spmm24_wg_cuda")
    index = b.get_device()
    if index < 0 or wg.get_device() != index:
        raise ValueError("spmm24_wg_cuda needs wg and b on one card")
    if wg.dtype != torch.int32 or b.dtype != torch.bfloat16 or \
            out_dtype != torch.bfloat16:
        raise ValueError(f"spmm24_wg_cuda takes int32 wg, bf16 b and out, "
                         f"not {wg.dtype}, {b.dtype} -> {out_dtype}")
    if not b.is_contiguous():
        b = b.contiguous()
    if n % 64 or (b.data_ptr() | wg.data_ptr()) % 16 or \
            not wg.is_contiguous():
        raise ValueError(f"spmm24_wg_cuda needs n % 64 == 0 and contiguous, "
                         f"16-byte aligned operands (n {n})")
    trace.mark("plan")
    plan = card_wg_plan(index, m, n, k_logical, block_n, splits)
    trace.mark("alloc")
    out = torch.empty((m, n), dtype=torch.bfloat16, device=b.device)
    ws = (torch.empty((plan.splits, m, n), dtype=torch.float32,
                      device=b.device) if plan.splits > 1 else None)
    trace.mark("launch")
    if plan.band:  # the 256-row unit
        SPMM24_WG256(index, wg.data_ptr(), b.data_ptr(), out.data_ptr(),
                     _build.ptr(ws), m, n, k_logical, ktp, plan.bn,
                     plan.splits, plan.kps, plan.band, plan.grid)
        trace.count("spmm24.wg256")
        spmm24_wg_cuda.wg256_launches += 1
    else:
        SPMM24_WG(index, wg.data_ptr(), b.data_ptr(), out.data_ptr(),
                  _build.ptr(ws), m, n, k_logical, ktp, plan.bn, plan.splits,
                  plan.kps, plan.grid)
    spmm24_wg_cuda.launches += 1
    return out


spmm24_wg_cuda.launches = 0
spmm24_wg_cuda.wg256_launches = 0  # of them, on the 256-row unit
