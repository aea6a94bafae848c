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
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ... import _build
from .prune_kernel import DTYPE_CODES
from .spmm24_kernel import _epilogue_plain

BLOCK_KS = (16, 32, 64, 128)
MAX_ELL = 1024  # slots per block-row that K5 lists in shared memory


def ell_spmm_plain(values, cols, b, *, block_size: int, block_k: int,
                   out_dtype: torch.dtype, alpha: float = 1.0,
                   beta: float = 0.0, c: Optional[torch.Tensor] = None,
                   transpose_out: bool = False) -> torch.Tensor:
    """Plain version of K4: gather each block-row's B slabs, one batched
    f32 product."""
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
                  transpose_out: bool = False) -> torch.Tensor:
    """Launch K4. ``values`` and ``b`` are brought to their promoted type;
    ``c`` goes to the kernel as f32."""
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
    out = torch.empty(out_shape, dtype=out_dtype, device=values.device)
    # (values, cols, b, c, out, M, N, Kb, bs, bk, ell, alpha, beta, tout,
    #  dtype, out_dtype, stream)
    launch = _build.load("ell_spmm", "ell_spmm_launch",
                         "ppppp" "iiiiii" "ff" "iii" "p")
    _build.check(launch(
        values.data_ptr(), cols.data_ptr(), b.data_ptr(), _build.ptr(c32),
        out.data_ptr(), m, n, kb, bs, bk, ell, float(alpha),
        float(beta) if c32 is not None else 0.0, int(transpose_out),
        DTYPE_CODES[dtype], DTYPE_CODES[out_dtype],
        _build.stream_ptr(values)), "ell_spmm")
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
    # (values_km, cols, b, out, M, N, Kb, bs, bk, ell, tout, dtype,
    #  out_dtype, stream)
    launch = _build.load("ell_expand", "ell_expand_launch",
                         "pppp" "iiiiiii" "ii" "p")
    _build.check(launch(
        values_km.data_ptr(), cols.data_ptr(), b.data_ptr(), out.data_ptr(),
        m, n, kb, bs, bk, ell, int(transpose_out), DTYPE_CODES[dtype],
        DTYPE_CODES[out_dtype], _build.stream_ptr(values_km)), "ell_expand")
    ell_expand_spmm_cuda.launches += 1
    return out


ell_expand_spmm_cuda.launches = 0
