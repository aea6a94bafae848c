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
M/2]`` and returns row-major C ``[M, n]``. The TPU scheduling knobs (tiles,
``pipeline``, chunking, VMEM budgets) have no counterpart.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from ... import _build
from .prune_kernel import DTYPE_CODES

# Tiles (rows of C, columns of C) of the sparse tensor-core fast path, in
# the order of the ``tile`` argument of spmm24_launch and ring24_launch.
SP_TILES = ((256, 128), (128, 128), (128, 64), (64, 64))
H100_SMS = 132


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


def card_tile(device: torch.device, m: int, n: int, k: int,
              fold: int = 1) -> int:
    """:func:`pick_tile` on the card that holds ``device``."""
    index = (device.index if device.index is not None
             else torch.cuda.current_device())
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
                 transpose_out: bool = False,
                 packed_codes: bool = False) -> torch.Tensor:
    """Plain version of K3: decompress, then an f32 product."""
    if packed_codes:
        codes = unpack_codes_fp(codes, v0.shape[0])
    a_t = expand_planes(v0, v1, codes)[:k_logical].to(torch.float32)
    acc = a_t.T @ b.to(torch.float32)
    return _epilogue_plain(acc, alpha, beta, c, transpose_out, out_dtype)


def spmm24_fold_plain(v0, v1, codes, b, *, k_logical: int,
                      out_dtype: torch.dtype, alpha: float = 1.0,
                      beta: float = 0.0,
                      c: Optional[torch.Tensor] = None) -> torch.Tensor:
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
            transpose_out, packed_codes, fold, what) -> torch.Tensor:
    k4, m = v0.shape
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
    out = torch.empty(out_shape, dtype=out_dtype, device=v0.device)
    # (v0, v1, codes, b, c, out, M, N, K, K4, alpha, beta, tout, packed,
    #  fold, dtype, out_dtype, tile, stream)
    launch = _build.load("spmm24", "spmm24_launch",
                         "pppppp" "iiii" "ff" "iiiiii" "p")
    # the entry point launches on the current card: make it the tensors'
    with torch.cuda.device(v0.device):
        _build.check(launch(
            v0.data_ptr(), v1.data_ptr(), codes.data_ptr(), b.data_ptr(),
            _build.ptr(c32), out.data_ptr(), m, n, k_logical, k4,
            float(alpha), float(beta) if c32 is not None else 0.0,
            int(transpose_out), int(packed_codes), fold, DTYPE_CODES[dtype],
            DTYPE_CODES[out_dtype],
            card_tile(v0.device, m, n, k_logical, fold),
            _build.stream_ptr(v0)), what)
    return out


def spmm24_cuda(v0, v1, codes, b, *, k_logical: int,
                out_dtype: torch.dtype, alpha: float = 1.0,
                beta: float = 0.0, c: Optional[torch.Tensor] = None,
                transpose_out: bool = False,
                packed_codes: bool = False) -> torch.Tensor:
    """Launch K3. Planes and ``b`` are brought to their promoted type (the
    kernel multiplies like types); ``c`` goes to the kernel as f32."""
    out = _launch(v0, v1, codes, b, k_logical=k_logical, out_dtype=out_dtype,
                  alpha=alpha, beta=beta, c=c, transpose_out=transpose_out,
                  packed_codes=packed_codes, fold=1, what="spmm24_cuda")
    spmm24_cuda.launches += 1
    return out


spmm24_cuda.launches = 0


def spmm24_fold_cuda(v0, v1, codes, b, *, k_logical: int,
                     out_dtype: torch.dtype, alpha: float = 1.0,
                     beta: float = 0.0,
                     c: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch K3 on fold=2 planes ``[2*k4, M/2]``; returns row-major
    ``C [M, n]``."""
    _check_fold(v0, k_logical)
    out = _launch(v0, v1, codes, b, k_logical=k_logical, out_dtype=out_dtype,
                  alpha=alpha, beta=beta, c=c, transpose_out=False,
                  packed_codes=False, fold=2, what="spmm24_fold_cuda")
    spmm24_fold_cuda.launches += 1
    return out


spmm24_fold_cuda.launches = 0
