"""Probes of K3's 2:4 tile: its feed and its MMAs apart, at two ring depths.

Port of ``experiments/units.py``, which asks whether a TPU overlaps the
2:4 expansion of A (VPU) with the dot (MXU) in one kernel body. Here the
question is what bounds a 2:4 tile on the H100, in the two Hopper designs
that K3 could take:

* ``design="mma_sp"``: K3's own sparse tensor-core tile
  (``csrc/sp24_tile.cuh``) with a compile-time mode and ring depth
  (``csrc/sp24_units.cu``), so the times come from the code that K3 and K7
  run;
* ``design="wgmma_sp"``: the same modes on a persistent TMA-fed
  ``wgmma.sp`` tile with split-k (``csrc/sp24_wg_tile.cuh``), on A packed
  once by :func:`pack_wgmma_sp` (the plan: :func:`wg_plan`);
* ``fp1``: expand-then-dense, the TPU's own choice, on TMA and ``wgmma``
  (``csrc/sp24_expand_tile.cuh``).

=========  ==========================  ====================================
JAX mode   here (mode, stages)         what runs
=========  ==========================  ====================================
expand     ``("feed", 4)``, ``2``      every k-step's loads of A's planes,
                                       codes and B, and its metadata; no
                                       ``mma.sp``
dot        ``("mma", 4)``, ``2``       the MMAs of every k-step on slot
                                       ``kt % stages``; no loads
both       ``("full", 4)``             K3's tile (the product)
parity     ``("full", 2)``             K3's tile on a two-slot ring
chain      ``("full", 1)``             a serial ring: load, wait, MMA
fp1        :func:`fp1_cuda`            A expanded into a dense tile in
                                       shared memory, then the dense
                                       tensor-core product
=========  ==========================  ====================================

What each computes, on planes ``v0, v1, codes [k4, M]`` and ``b [k, n]``
(bf16; the tile ``bm x bn``: ``spmm24_kernel.pick_tile``'s for
``mma_sp``, 128 rows by :func:`wg_plan`'s width for ``wgmma_sp``):

* ``full``: ``C = A @ b``, as :func:`~..ops.kernels.spmm24_kernel.spmm24_plain`.
* ``feed``: every row of block ``i`` (rows ``i*bm ..``) gets ``sum over g
  of v0[g, i*bm] + v1[g, i*bm]`` (the sum over k of the block's first row
  of A, as the JAX ``expand`` writes it), in f32 and then bf16; and
  ``side[j, i]``, one uint32 word a block (as int32), is the XOR of every
  metadata word the block built (``spmm24_kernel.meta_words``; the
  ``wgmma_sp`` tile loads the same words in another order, and their XOR
  does not depend on it), so that neither the loads nor the metadata are
  dead code.
* ``mma``: ``C = sum over kt < KT of A_s @ b_s`` with ``s = kt % stages``
  (``KT = ceil(k / 64)``; ``A_s``, ``b_s``: k-step ``s``'s 64 columns of A
  and rows of b), the only k-steps it staged.
* ``fp1``: ``out[m, n] = sum over q, g of A[m, 4g + q] * b[q*k4 + g, n]``:
  ``run_probe_fp1``'s product, whose slab holds A's k axis quarter-major.
  :func:`fp1_operand` permutes b once into ``b'[4g + q] = b[q*k4 + g]``,
  and the kernel computes ``A @ b'``.

The JAX ``dot``, ``both``, ``parity`` and ``chain`` multiply scratch that
nothing wrote, so JAX defines no output for them; their counterparts here
are held to their own plain versions only. ``expand`` and ``fp1`` are held
to the JAX kernels (``tests/test_torch_units_probe.py``).

A measurement module: the port does not import it. The CUDA wrappers
launch their kernel or raise; the tests call the plain versions.

Usage (needs one GPU)::

    python -m sparsifyme_tpu_torch.bench.units_probe           # both designs,
        # fp1, K3 and torch.matmul at the five shapes
    python -m sparsifyme_tpu_torch.bench.units_probe --plans   # wgmma_sp's
        # product under every plan (width x splits) at the five shapes
    python -m sparsifyme_tpu_torch.bench.units_probe --ablate  # fp1 with
        # parts of its work taken out (FP1_ABLATIONS) at U and D
    python -m sparsifyme_tpu_torch.bench.units_probe --depths  # wgmma_sp
        # rebuilt at ring depths 5 and 6 beside 4, at the five shapes
"""

from __future__ import annotations

import collections
import functools
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, NamedTuple, Optional, Tuple, Union

import torch

from .. import _build
from ..ops.kernels import ell_kernel as ellk
from ..ops.kernels import spmm24_kernel as k3

MODES = {"full": 0, "feed": 1, "mma": 2}
# the (mode, stages) pairs csrc/sp24_units.cu builds
VARIANTS = (("full", 4), ("full", 2), ("full", 1), ("feed", 4), ("feed", 2),
            ("mma", 4), ("mma", 2))
DESIGNS = ("mma_sp", "wgmma_sp")
KS = 64  # logical k of one stage of the tile
WG_BM = 128  # rows of a wgmma_sp or fp1 tile: two warpgroups of 64
# fp1_launch's ctypes spec: (v0, v1, codes, b, out, M, N, K, K4, device,
# stream)
FP1_SPEC = "ppppp" "iiii" "i" "p"
# --ablate: the expand-then-dense tile rebuilt with parts of its work taken
# out, {build name: [(text of csrc/sp24_expand_tile.cuh, replacement)]}; an
# ablated build's output is wrong by design
FP1_ABLATIONS = {
    "no expand ALU": [("          expand8(a, b, cd, q);",
                       "          make_uint4(a.x, b.y, cd.x, q);")],
    "no expansion": [("    for (int q = 0; q < 4; ++q)\n",
                      "    for (int q = 0; q < 0; ++q)\n")],
    "no proxy fence": [("    fence_proxy_async();\n", "")],
    "no products": [("      for (int k = 0; k < kBK / 16; ++k)\n",
                     "      for (int k = 0; k < 0; ++k)\n")],
}
# wgsp_launch's ctypes spec: (a, b, out, side, ws, parts, M, N, K, KTP, mode,
# stages, bn, splits, kps, grid, device, stream)
WG_SPEC = "pppppp" "iiii" "ii" "iiii" "i" "p"
# --depths: the wgmma_sp tile rebuilt with its 4-stage variants at these
# ring depths (csrc/sp24_wg_tile.cuh's launch_variant; 6 is the most its
# shared memory holds at 128 columns)
WG_DEPTHS = (5, 6)
WG_DEPTH_LINE = "    return launch_kernel<MODE, ST, BN>(p, grid, s);"
# m x n x k (b = 32 folded into m): the JAX probe's three shapes, then E and
# D of PERF.md, where K3 loses to the dense product
SHAPES = [(100352, 128, 512), (25088, 256, 1024), (401408, 64, 576),
          (401408, 256, 64), (6272, 512, 4608)]


def _validate(v0, v1, codes, b, what):
    if not v0.is_cuda or any(t.device != v0.device for t in (v1, codes, b)):
        raise ValueError(f"{what} needs CUDA tensors on one card")
    if v0.dtype != torch.bfloat16 or v1.dtype != torch.bfloat16 or \
            b.dtype != torch.bfloat16 or codes.dtype != torch.uint8:
        raise TypeError(f"{what} takes bf16 planes and b, uint8 codes")
    k4, m = v0.shape
    k, n = b.shape
    if v1.shape != v0.shape or codes.shape != v0.shape or k > 4 * k4:
        raise ValueError(f"{what}: planes {tuple(v0.shape)}, codes "
                         f"{tuple(codes.shape)}, b {tuple(b.shape)}")
    if m % 8 or n % 8:
        raise ValueError(f"{what} needs M and N multiples of 8, got {m}, {n}")
    return k4, m, k, n


class WgPlan(NamedTuple):
    """A launch of the ``wgmma_sp`` tile: its width, split count, k-steps a
    split, work units (m-tile, n-tile, split) and persistent blocks."""
    bn: int
    splits: int
    kps: int
    units: int
    grid: int


# A k-step of the wgmma_sp tile on one SM (microseconds, by tile width):
# its time under the one-split plan at D (units_probe --plans, PERF.md)
WG_STEP_US = {64: 0.36, 128: 0.43}


def wg_plan(m: int, n: int, k: int, sms: int = k3.H100_SMS) -> WgPlan:
    """The plan of the ``wgmma_sp`` tile at ``m x n x k`` on ``sms`` SMs:
    128 columns where n allows, else 64; among split counts up to
    ``ell_kernel.MAX_SPLITS`` that leave no split empty, the least
    estimated time: waves of units on ``sms`` persistent blocks, each unit
    its k-steps (:data:`WG_STEP_US`) and its epilogue, against the bytes,
    plus split-k's second pass (``ell_kernel.ell_plan``'s constants); ties
    go to fewer splits."""
    if m % WG_BM or n % 64 or m <= 0 or n <= 0 or k <= 0:
        raise ValueError(f"the wgmma_sp tile needs M % {WG_BM} == 0 and "
                         f"n % 64 == 0, got {m} x {n} x {k}")
    bn = 128 if n % 128 == 0 else 64
    kt = -(-k // KS)
    tiles = (m // WG_BM) * (n // bn)
    floor_us = (1.25 * m * k + 2 * k * n + 2 * m * n) / ellk.BYTES_PER_US
    best = None
    for splits in range(1, min(kt, ellk.MAX_SPLITS) + 1):
        kps = -(-kt // splits)
        if (splits - 1) * kps >= kt:
            continue  # the last split would be empty
        units = tiles * splits
        epi_us = WG_BM * bn * (4 if splits > 1 else 2) / ellk.EPI_BYTES_PER_US
        est = max(-(-units // sms) * (kps * WG_STEP_US[bn] + epi_us),
                  floor_us)
        if splits > 1:  # f32 partials written, read by the second pass
            est += ellk.REDUCE_US + (8 * splits + 2) * m * n \
                / ellk.BYTES_PER_US
        if best is None or est < best[0]:
            best = (est, WgPlan(bn, splits, kps, units, min(units, sms)))
    return best[1]


def wg_walk(plan: WgPlan, m: int, n: int, k: int
            ) -> List[List[Tuple[int, int, int, List[int]]]]:
    """The units each persistent block of the ``wgmma_sp`` tile takes, in
    its order: one list per block of ``(m_tile, n_tile, split, k-steps)``,
    the kernel's own loops (``sp24w::Unit``) replayed."""
    kt = -(-k // KS)
    n_tiles = n // plan.bn
    out = []
    for blk in range(plan.grid):
        walk = []
        for u in range(blk, plan.units, plan.grid):
            split, t = u % plan.splits, u // plan.splits
            k0 = split * plan.kps
            walk.append((t // n_tiles, t % n_tiles, split,
                         list(range(k0, min(kt, k0 + plan.kps)))))
        out.append(walk)
    return out


def units_tile(v0: torch.Tensor, b: torch.Tensor,
               design: str = "mma_sp") -> Tuple[int, int]:
    """``(bm, bn)``: the tile :func:`units_cuda` launches on these
    operands: :func:`~..ops.kernels.spmm24_kernel.card_tile`'s for
    ``mma_sp``, 128 rows by :func:`wg_plan`'s width for ``wgmma_sp``."""
    m, n, k = v0.shape[1], b.shape[1], b.shape[0]
    if design == "wgmma_sp":
        return WG_BM, wg_plan(m, n, k).bn
    return k3.SP_TILES[k3.card_tile(v0.device, m, n, k)]


def _to_int32(words: torch.Tensor) -> torch.Tensor:
    """uint32 values held in int64, as int32 bits."""
    return ((words + 2 ** 31) % 2 ** 32 - 2 ** 31).to(torch.int32)


def sw64_offset(r: int, c: int) -> int:
    """Byte offset of compressed column ``c`` of row ``r`` in a ``128 x
    32`` bf16 tile of the ``wgmma_sp`` operand: 64-byte rows, 16-byte chunk
    ``c // 8`` at ``c // 8 ^ ((r >> 1) & 3)``, the 64-byte swizzle that
    ``wgmma`` reads K-major A in."""
    return r * 64 + (((c // 8) ^ ((r >> 1) & 3)) << 4) + (c % 8) * 2


WG_WORDS = 2304  # 32-bit words of a tile's k-step: 8 KB of A, 1 KB of meta


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
      becomes (0, 1), as ``spmm24_kernel.nibbles16`` makes it).

    Plain PyTorch; :func:`unpack_wgmma_sp` inverts it."""
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
    src = torch.arange(4, device=dev)[None, :] ^ ((r[:, None] >> 1) & 3)
    vals = vals[:, :, r[:, None], src]  # the XOR is its own inverse
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
    src = torch.arange(4, device=dev)[None, :] ^ ((r[:, None] >> 1) & 3)
    vals = vals[:, :, r[:, None], src]  # [kt, tile, row, chunk, 8]
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


def expand_slot_offset(k: int, m: int, bk: int = KS) -> int:
    """Byte offset of dense ``A^T`` element ``(k, m)`` in a ``bk x 128``
    slot of the ``fp1`` tile: ``sp24x::slot_offset`` of
    ``csrc/sp24_expand_tile.cuh`` (two boxes of 64 rows, k-rows of 128
    bytes, 16-byte chunk ``c`` at ``c ^ (k & 7)``)."""
    return ((m // 64) * bk * 128 + k * 128
            + ((((m % 64) // 8) ^ (k & 7)) << 4) + (m % 8) * 2)


def _units_mma_sp(v0, v1, codes, b, mode, stages, k4, m, k, n):
    tile = k3.card_tile(v0.device, m, n, k)
    bm, bn = k3.SP_TILES[tile]
    out = torch.empty((m, n), dtype=torch.bfloat16, device=v0.device)
    side = torch.empty((-(-n // bn), -(-m // bm)), dtype=torch.int32,
                       device=v0.device)  # the kernel writes every word
    # (v0, v1, codes, b, out, side, M, N, K, K4, mode, stages, tile,
    #  device, stream)
    launch = _build.load("sp24_units", "units24_launch",
                         "pppppp" "iiii" "iiii" "p")
    _build.check(launch(
        v0.data_ptr(), v1.data_ptr(), codes.data_ptr(), b.data_ptr(),
        out.data_ptr(), side.data_ptr(), m, n, k, k4, MODES[mode], stages,
        tile, _build.device_index(v0), _build.stream_ptr(v0)),
        f"units_cuda({mode}, {stages})")
    return out, side


def _units_wgmma_sp(packed, b, mode, stages, m, k, n, plan):
    dev = b.device
    ktp = packed.shape[0]
    if packed.shape != (ktp, m // WG_BM, WG_WORDS) or packed.device != dev \
            or packed.dtype != torch.int32 or -(-k // KS) > ktp:
        raise ValueError("units_cuda: packed is not pack_wgmma_sp of these "
                         "planes")
    out = torch.empty((m, n), dtype=torch.bfloat16, device=dev)
    side = torch.empty((n // plan.bn, m // WG_BM), dtype=torch.int32,
                       device=dev)  # the kernel writes every word
    ws = parts = None
    if plan.splits > 1:
        ws = torch.empty((plan.splits, m, n), dtype=torch.float32,
                         device=dev)
        parts = torch.empty((plan.splits, side.numel()), dtype=torch.int32,
                            device=dev)
    # (a, b, out, side, ws, parts, M, N, K, KTP, mode, stages, bn, splits,
    #  kps, grid, device, stream)
    launch = _build.load("sp24_wg_units", "wgsp_launch", WG_SPEC)
    _build.check(launch(
        packed.data_ptr(), b.data_ptr(), out.data_ptr(),
        side.data_ptr(), _build.ptr(ws), _build.ptr(parts), m, n, k, ktp,
        MODES[mode], stages, plan.bn, plan.splits, plan.kps, plan.grid,
        _build.device_index(b), _build.stream_ptr(b)),
        f"units_cuda({mode}, {stages}, wgmma_sp)")
    return out, side


@functools.lru_cache(maxsize=256)
def _card_wg_plan(index: int, m: int, n: int, k: int) -> WgPlan:
    return wg_plan(m, n, k, k3.sm_count(index))


def units_cuda(v0, v1, codes, b, *, mode: str, stages: int,
               design: str = "mma_sp", packed: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the 2:4 tile of ``design`` in ``mode`` with a
    ``stages``-deep ring on CUDA tensors, on the tile of
    :func:`units_tile`; returns ``(out [M, n] bf16, side [ceil(n/bn),
    ceil(M/bm)] int32)``. ``wgmma_sp`` reads A as ``packed``, the
    :func:`pack_wgmma_sp` of the planes (made here when it is not given:
    pass it to keep the pack out of a timed call), and needs M % 128 == 0
    and n % 64 == 0."""
    if (mode, stages) not in VARIANTS:
        raise ValueError(f"({mode!r}, {stages}) is not one of {VARIANTS}")
    if design not in DESIGNS:
        raise ValueError(f"design {design!r} is not one of {DESIGNS}")
    k4, m, k, n = _validate(v0, v1, codes, b, "units_cuda")
    if design == "mma_sp":
        v0, v1, codes, b = (t.contiguous() for t in (v0, v1, codes, b))
        res = _units_mma_sp(v0, v1, codes, b, mode, stages, k4, m, k, n)
    else:
        plan = _card_wg_plan(_build.device_index(b), m, n, k)
        if packed is None:
            packed = pack_wgmma_sp(v0, v1, codes)
        res = _units_wgmma_sp(packed, b.contiguous(), mode, stages, m, k, n,
                              plan)
    units_cuda.launches[(design, mode, stages)] += 1
    return res


units_cuda.launches = collections.Counter()  # by (design, mode, stages)


def _xor_halves(w: torch.Tensor) -> torch.Tensor:
    """XOR over the last axis (a power of two long)."""
    while w.shape[-1] > 1:
        h = w.shape[-1] // 2
        w = w[..., :h] ^ w[..., h:]
    return w[..., 0]


def meta_xor(codes: torch.Tensor, k: int, bm: int) -> torch.Tensor:
    """The XOR of the metadata words a block of ``bm`` rows builds over the
    ``ceil(k / 64)`` k-steps, per block ``[ceil(M/bm)]`` int64, from the
    plain ``build_meta`` (``spmm24_kernel.meta_words``); rows past M are
    zero bytes, as the kernel stages them."""
    k4, m = codes.shape
    nb = -(-m // bm)
    c = torch.zeros((k4, nb * bm), dtype=torch.uint8)
    c[:, :m] = codes.cpu()
    acc = torch.zeros(nb, dtype=torch.int64)
    for kt in range(-(-k // KS)):
        words = k3.meta_words(k3.staged_codes(c, k4, False, kt), k4, False,
                              kt)  # [2, nb * bm/16, 8, 2]
        words = words.reshape(2, nb, bm // 16, 16).permute(1, 0, 2, 3)
        acc ^= _xor_halves(words.reshape(nb, -1))
    return acc


def units_plain(v0, v1, codes, b, *, mode: str, stages: int, bm: int,
                bn: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`units_cuda` on a ``bm x bn`` tile (the
    module docstring says what each mode computes)."""
    if (mode, stages) not in VARIANTS:
        raise ValueError(f"({mode!r}, {stages}) is not one of {VARIANTS}")
    k4, m = v0.shape
    k, n = b.shape
    kt_n = -(-k // KS)
    side = torch.zeros((-(-n // bn), -(-m // bm)), dtype=torch.int32,
                       device=v0.device)
    if mode == "full":
        return k3.spmm24_plain(v0, v1, codes, b, k_logical=k,
                               out_dtype=torch.bfloat16), side
    if mode == "feed":
        g = min(k4, kt_n * KS // 4)
        first = (v0[:g, ::bm].float() + v1[:g, ::bm].float()).sum(0)
        out = first.repeat_interleave(bm)[:m, None].expand(m, n)
        words = meta_xor(codes, k, bm)
        words = (words + 2 ** 31) % 2 ** 32 - 2 ** 31  # the uint32 bits
        side[:] = words.to(torch.int32).to(v0.device)[None, :]
        return out.to(torch.bfloat16).contiguous(), side
    a_t = torch.zeros((kt_n * KS, m), dtype=torch.float32, device=v0.device)
    full = k3.expand_planes(v0, v1, codes).float()
    a_t[:min(full.shape[0], kt_n * KS)] = full[:kt_n * KS]
    bp = torch.zeros((kt_n * KS, n), dtype=torch.float32, device=b.device)
    bp[:k] = b.float()
    acc = torch.zeros((m, n), dtype=torch.float32, device=v0.device)
    for s in range(min(stages, kt_n)):
        times = (kt_n - s + stages - 1) // stages  # k-steps on slot s
        ks = slice(s * KS, (s + 1) * KS)
        acc += times * (a_t[ks].T @ bp[ks])
    return acc.to(torch.bfloat16), side


def fp1_operand(b: torch.Tensor) -> torch.Tensor:
    """``b'[4g + q] = b[q*k4 + g]`` for ``b [4*k4, n]``: the rows of b in
    the order in which the expand-then-dense tile reads A's k axis."""
    k, n = b.shape
    if k % 4:
        raise ValueError(f"b needs 4*k4 rows, got {k}")
    return b.reshape(4, k // 4, n).permute(1, 0, 2).reshape(k, n)


def fp1_cuda(v0, v1, codes, bp) -> torch.Tensor:
    """Launch the expand-then-dense tile: ``A @ bp`` in bf16 with ``bp =
    fp1_operand(b)``, which :func:`fp1_plain` computes from ``b``. M a
    multiple of 128, n of 64."""
    k4, m, k, n = _validate(v0, v1, codes, bp, "fp1_cuda")
    if m % WG_BM or n % 64:
        raise ValueError(f"fp1_cuda needs M % {WG_BM} == 0 and n % 64 == 0,"
                         f" got {m}, {n}")
    v0, v1, codes, bp = (t.contiguous() for t in (v0, v1, codes, bp))
    out = torch.empty((m, n), dtype=torch.bfloat16, device=v0.device)
    # (v0, v1, codes, b, out, M, N, K, K4, device, stream)
    launch = _build.load("sp24_units", "fp1_launch", FP1_SPEC)
    _build.check(launch(
        v0.data_ptr(), v1.data_ptr(), codes.data_ptr(), bp.data_ptr(),
        out.data_ptr(), m, n, k, k4, _build.device_index(v0),
        _build.stream_ptr(v0)), "fp1_cuda")
    fp1_cuda.launches += 1
    return out


fp1_cuda.launches = 0


def fp1_plain(v0, v1, codes, b) -> torch.Tensor:
    """Plain version of ``run_probe_fp1``'s product, from b in the JAX
    probe's row order: ``sum over q, g of A[m, 4g + q] * b[q*k4 + g]``."""
    k4, m = v0.shape
    a_q = k3.expand_planes(v0, v1, codes).float().reshape(k4, 4, m)
    a_q = a_q.permute(1, 0, 2).reshape(4 * k4, m)  # row q*k4 + g
    return (a_q.T @ b.float()).to(torch.bfloat16)


# --- the probe ---------------------------------------------------------------

def operands(m: int, n: int, k: int, gen: torch.Generator):
    """K3's operands at ``m x n x k``: the planes of a pruned random bf16
    A and a random b, from ``gen`` on its device."""
    from ..ops.kernels.prune_kernel import (prune_compress_24_cuda,
                                            prune_compress_24_plain)

    dev = gen.device
    a = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
    b = torch.randn((k, n), generator=gen, device=dev).to(torch.bfloat16)
    compress = (prune_compress_24_cuda if dev.type == "cuda"
                else prune_compress_24_plain)
    v0, v1, codes = compress(a)
    return v0, v1, codes, b


def errors(got: torch.Tensor, want: torch.Tensor) -> Tuple[float, float]:
    """The largest absolute error, and it over the largest ``|want|``."""
    err = float((got.float() - want.float()).abs().max())
    return err, err / max(float(want.float().abs().max()), 1e-30)


def check(v0, v1, codes, b, what: Union[Tuple[str, int], str],
          design: str = "mma_sp", packed=None) -> Tuple[float, float]:
    """Hold one launch of ``what``, a ``(mode, stages)`` of
    :data:`VARIANTS` in ``design`` (``wgmma_sp`` on ``packed``, made here
    when not given) or ``"fp1"`` (b in the JAX probe's order), to its plain
    version on the same CUDA operands: the output within 2e-2 of the largest
    ``|want|``, the side words exactly. Returns :func:`errors`."""
    if what == "fp1":
        got = fp1_cuda(v0, v1, codes, fp1_operand(b))
        want = fp1_plain(v0, v1, codes, b)
    else:
        mode, st = what
        got, side = units_cuda(v0, v1, codes, b, mode=mode, stages=st,
                               design=design, packed=packed)
        bm, bn = units_tile(v0, b, design)
        want, want_side = units_plain(v0, v1, codes, b, mode=mode,
                                      stages=st, bm=bm, bn=bn)
        if not torch.equal(side, want_side):
            raise AssertionError(f"units {what} {design}: the side words "
                                 "differ from the plain ones")
    err = errors(got, want)
    if not err[1] <= 2e-2:
        raise AssertionError(f"units {what} {design}: rel err {err[1]} > "
                             "2e-2")
    return err


def bounds_ms(m: int, n: int, k: int) -> Dict[str, Tuple[float, str]]:
    """Each probe's bound (ms, what bounds it) on the data sheet's H100:
    ``feed`` the bytes it must move (A's planes at 1.25 B a logical
    element, b and C once each), ``mma`` the 2:4 operations at the 2:4
    rate (and C's bytes), ``full`` K3's bound (the larger of the two),
    ``fp1`` the same bytes against the dense operations at the dense
    rate."""
    from .roofline import H100, bound_by

    byts = 1.25 * m * k + 2.0 * k * n + 2.0 * m * n
    flops = 2.0 * m * n * k

    def ms(f, b, rate=H100.sparse24_tflops):
        return (max(f / (rate * 1e12), b / (H100.hbm_gbps * 1e9)) * 1e3,
                bound_by(f, rate, b))
    return {"feed": ms(0.0, byts), "mma": ms(flops, 2.0 * m * n),
            "full": ms(flops, byts),
            "fp1": ms(flops, byts, H100.dense_tflops)}


def overlap_frac(feed: float, mma: float, both: float) -> float:
    """``(feed + mma - both) / min(feed, mma)``: 1 where one part hides the
    other, 0 where they add up."""
    return (feed + mma - both) / min(feed, mma)


def probe_shape(m: int, n: int, k: int, gen: torch.Generator, *,
                iters: int = 20, reps: int = 5) -> dict:
    """Every variant in both designs, :func:`fp1_cuda`, K3 and
    ``torch.matmul`` on the dense A at one shape on the card: each kernel
    held to its plain version (:func:`check`) and timed (``wgmma_sp`` on A
    packed once, outside the timing). Returns per kernel (``wg_`` before a
    ``wgmma_sp`` variant) its relative error, its device time ``ms`` (calls
    replayed in a CUDA graph: ``utils.timing.time_graph``) and
    ``eager_ms`` (calls queued one by one: ``time_kernel``, which counts
    the host's time to queue a call where that is longer), and
    ``overlap_frac`` per design and ring depth from the device times."""
    from ..utils.timing import time_graph, time_kernel

    v0, v1, codes, b = operands(m, n, k, gen)
    bm, bn = units_tile(v0, b)
    plan = wg_plan(m, n, k, k3.sm_count(_build.device_index(v0)))
    res = {"shape": f"{m}x{n}x{k}", "tile": f"{bm}x{bn}",
           "wg_plan": plan._asdict(), "ms": {}, "eager_ms": {}, "err": {}}
    ops = (v0, v1, codes, b)
    packed = pack_wgmma_sp(v0, v1, codes)

    def timed(name, fn, args):
        res["ms"][name] = time_graph(fn, args, iters=iters, reps=reps).ms
        res["eager_ms"][name] = time_kernel(fn, args, iters=iters,
                                            reps=reps).ms
    for design, pre in (("mma_sp", ""), ("wgmma_sp", "wg_")):
        for mode, st in VARIANTS:
            name = f"{pre}{mode}_s{st}"
            res["err"][name] = check(*ops, (mode, st), design, packed)[1]
            # wgmma_sp's packed A cycles with the other operands' replicas
            timed(name,
                  lambda *x, kw=dict(mode=mode, stages=st, design=design):
                  units_cuda(*x[:4], packed=x[4] if x[4:] else None, **kw),
                  ops + ((packed,) if pre else ()))
    res["err"]["fp1"] = check(*ops, "fp1")[1]
    timed("fp1", fp1_cuda, (v0, v1, codes, fp1_operand(b)))
    kw = dict(k_logical=k, out_dtype=torch.bfloat16)
    timed("k3", lambda *x: k3.spmm24_cuda(*x, **kw), ops)
    dense_a = k3.expand_planes(v0, v1, codes).T.contiguous()
    timed("matmul", torch.matmul, (dense_a, b))
    for pre in ("", "wg_"):
        for st in (4, 2):
            feed, mma, both = (res["ms"][f"{pre}{md}_s{st}"]
                               for md in ("feed", "mma", "full"))
            res[f"{pre}overlap_frac_s{st}"] = overlap_frac(feed, mma, both)
    res["bounds"] = bounds_ms(m, n, k)
    return res


def plan_sweep(m: int, n: int, k: int, gen: torch.Generator, *,
               iters: int = 20, reps: int = 5) -> Dict[str, float]:
    """The ``wgmma_sp`` tile's product (4 stages) at one shape under every
    plan it takes: widths 64 and 128 that divide n, 1 to
    ``ell_kernel.MAX_SPLITS`` splits that leave none empty; device ms
    (``time_graph``) by ``"<bn>x<splits>"`` (each held to the product
    first), and ``"picked"``: :func:`wg_plan`'s."""
    from ..utils.timing import time_graph

    v0, v1, codes, b = operands(m, n, k, gen)
    packed = pack_wgmma_sp(v0, v1, codes)
    want = k3.spmm24_plain(v0, v1, codes, b, k_logical=k,
                           out_dtype=torch.bfloat16)
    kt, sms = -(-k // KS), k3.sm_count(_build.device_index(b))
    out = {}
    for bn in (64, 128):
        for splits in range(1, min(kt, ellk.MAX_SPLITS) + 1):
            kps = -(-kt // splits)
            if n % bn or (splits - 1) * kps >= kt:
                continue
            units = (m // WG_BM) * (n // bn) * splits
            plan = WgPlan(bn, splits, kps, units, min(units, sms))

            def run(bb, pk, plan=plan):
                return _units_wgmma_sp(pk, bb, "full", 4, m, k, n, plan)
            rel = errors(run(b, packed)[0], want)[1]
            if not rel <= 2e-2:
                raise AssertionError(f"plan {plan}: rel err {rel}")
            out[f"{bn}x{splits}"] = time_graph(
                run, (b, packed), iters=iters, reps=reps).ms
    pick = wg_plan(m, n, k, sms)
    out["picked"] = f"{pick.bn}x{pick.splits}"
    return out


def run_ablate(card: str) -> int:
    """``fp1`` whole and under each of :data:`FP1_ABLATIONS` at U and D:
    device ms (``time_graph``)."""
    from ..utils.timing import time_graph

    nvcc = _build.find_nvcc()
    _build.build_all()
    key = ("sp24_units", "fp1_launch")
    with tempfile.TemporaryDirectory() as tmp:
        builds = _rebuilt({name: ("sp24_units", "fp1_launch", FP1_SPEC,
                                  "sp24_expand_tile.cuh", edits)
                           for name, edits in FP1_ABLATIONS.items()},
                          nvcc, tmp)
    gen = torch.Generator(device="cuda").manual_seed(0)
    try:
        for m, n, k in (SHAPES[1], SHAPES[4]):
            v0, v1, codes, b = operands(m, n, k, gen)
            ops = (v0, v1, codes, fp1_operand(b))

            def ms():
                return time_graph(fp1_cuda, ops, iters=20, reps=5).ms
            line = f"fp1 {m}x{n}x{k} device ms: whole {ms():.4f}"
            for name, fn in builds.items():
                _build._entries[key] = fn
                line += f", {name} {ms():.4f}"
            _build._entries.pop(key)
            print(f"{line} | {card}", flush=True)
    finally:
        _build._entries.pop(key, None)
    return 0


def _rebuilt(builds: Dict[str, tuple], nvcc: str, tmp: str) -> dict:
    """``{name: C entry}`` of the sources rebuilt with ``builds[name] =
    (source, entry, spec, edited file, edits)``, in parallel."""
    from .coo_probe import _ablated

    with ThreadPoolExecutor(len(builds)) as pool:
        futs = [pool.submit(_ablated, src, entry, spec, edits,
                            Path(tmp) / str(i) / f"lib{src}.so", nvcc, name)
                for i, (src, entry, spec, name, edits)
                in enumerate(builds.values())]
        return dict(zip(builds, (f.result() for f in futs)))


def run_depths(card: str) -> int:
    """The ``wgmma_sp`` product and feed at ring depths 4 and
    :data:`WG_DEPTHS` (rebuilt) at the five shapes: device ms
    (``time_graph``), each product held to K3's plain version."""
    from ..utils.timing import time_graph

    nvcc = _build.find_nvcc()
    _build.build_all()
    key = ("sp24_wg_units", "wgsp_launch")
    with tempfile.TemporaryDirectory() as tmp:
        builds = _rebuilt({d: ("sp24_wg_units", "wgsp_launch", WG_SPEC,
                               "sp24_wg_tile.cuh", [(WG_DEPTH_LINE, (
                                   "    return launch_kernel<MODE, (ST == 4"
                                   f" ? {d} : ST), BN>(p, grid, s);"))])
                           for d in WG_DEPTHS}, nvcc, tmp)
    gen = torch.Generator(device="cuda").manual_seed(0)
    try:
        for m, n, k in SHAPES:
            v0, v1, codes, b = operands(m, n, k, gen)
            packed = pack_wgmma_sp(v0, v1, codes)
            want = k3.spmm24_plain(v0, v1, codes, b, k_logical=k,
                                   out_dtype=torch.bfloat16)
            line = f"{m}x{n}x{k} wgmma_sp device ms by depth:"
            for d in (4,) + WG_DEPTHS:
                if d != 4:
                    _build._entries[key] = builds[d]
                for mode in ("full", "feed"):
                    def run(bb, pk, mode=mode):
                        return units_cuda(v0, v1, codes, bb, mode=mode,
                                          stages=4, design="wgmma_sp",
                                          packed=pk)
                    if mode == "full":
                        rel = errors(run(b, packed)[0], want)[1]
                        if not rel <= 2e-2:
                            raise AssertionError(f"depth {d}: rel err {rel}")
                    t = time_graph(run, (b, packed), iters=20, reps=5).ms
                    line += f" {mode}{d}={t:.4f}"
                _build._entries.pop(key, None)
            print(f"{line} | {card}", flush=True)
    finally:
        _build._entries.pop(key, None)
    return 0


def card_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True,
                          capture_output=True, text=True).stdout.strip()


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("units_probe: needs a CUDA device", file=sys.stderr)
        return 1
    card = card_line()
    print(f"card: {card}", flush=True)
    if "--ablate" in argv:
        return run_ablate(card)
    if "--depths" in argv:
        return run_depths(card)
    gen = torch.Generator(device="cuda").manual_seed(0)
    if "--plans" in argv:
        for m, n, k in SHAPES:
            r = plan_sweep(m, n, k, gen)
            print(f"{m}x{n}x{k} wgmma_sp full_s4 ms by <bn>x<splits>: "
                  + " ".join(f"{p}={v:.4f}" for p, v in r.items()
                             if p != "picked")
                  + f" | picked {r['picked']} | {card}", flush=True)
        return 0
    for m, n, k in SHAPES:
        r = probe_shape(m, n, k, gen)
        ms, eg, bd, pl = r["ms"], r["eager_ms"], r["bounds"], r["wg_plan"]
        print(f"{r['shape']} tile {r['tile']} | wgmma_sp tile 128x{pl['bn']}"
              f" splits {pl['splits']} grid {pl['grid']} | device ms: "
              + " ".join(f"{v}={ms[v]:.4f}" for v in ms)
              + " | eager ms: " + " ".join(f"{v}={eg[v]:.4f}" for v in eg)
              + f" | overlap_frac mma_sp s4={r['overlap_frac_s4']:.3f} "
              f"s2={r['overlap_frac_s2']:.3f} wgmma_sp "
              f"s4={r['wg_overlap_frac_s4']:.3f} "
              f"s2={r['wg_overlap_frac_s2']:.3f} | bound ms feed "
              f"{bd['feed'][0]:.4f} ({bd['feed'][1]}) mma {bd['mma'][0]:.4f}"
              f" ({bd['mma'][1]}) both {bd['full'][0]:.4f} ({bd['full'][1]})"
              f" fp1 {bd['fp1'][0]:.4f} ({bd['fp1'][1]}) | max rel err "
              f"{max(r['err'].values()):.2e} | {card}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
