"""Wrapper of kernel K6 (segmented block-row COO SpMM) beside its plain
PyTorch version, and the block-row packer that builds their operand.

K6 ``csrc/coo_spmm.cu`` replaces
``sparsifyme_tpu/ops/kernels/coo_kernel.py:spmm_coo_pallas`` (``:169``). Its
``"matmul"`` and ``"slices"`` gathers are two TPU formulations of one
function; K6 is the one kernel behind both names. It is bound by the
operations (2 * nnz * N f32 multiply-adds on the CUDA cores) at the
shapes of BASELINE config 2; the source says how its design meets that.

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
has no limit on k: it streams B rows from device memory.
"""

from __future__ import annotations

import torch

from ... import _build
from .prune_kernel import DTYPE_CODES

GROUP = 8  # E must be a multiple of this, as on the TPU
SLOT_QUANTUM = 128  # the packer pads E to a multiple of this, as on the TPU
MAX_BLOCK_ROWS = 256  # K6 keeps a [block_rows + 1, 128] f32 tile on chip
MAX_BLOCK_ROW_COUNT = 65535  # K6's grid y dimension


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


def spmm_coo_cuda(vals2, cols2, roff2, b, *, m: int,
                  block_rows: int = 128) -> torch.Tensor:
    """Launch K6."""
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
    if mb > MAX_BLOCK_ROW_COUNT:
        raise ValueError(f"{mb} block-rows > {MAX_BLOCK_ROW_COUNT}")
    if e % GROUP:
        raise ValueError(f"entry count {e} not a multiple of {GROUP}")
    if vals2.dtype not in DTYPE_CODES or b.dtype not in DTYPE_CODES:
        raise TypeError(f"coo_spmm kernel takes float32/bfloat16, not "
                        f"{vals2.dtype} values and {b.dtype} b")
    out = torch.empty((batch, m, n), dtype=torch.float32, device=b.device)
    if out.numel() == 0:
        return out
    vals2 = vals2.contiguous()
    cols2 = cols2.to(torch.int32).contiguous()
    roff2 = roff2.to(torch.int32).contiguous()
    b = b.contiguous()
    # (vals2, cols2, roff2, b, out, mb, E, bm, m, k, n, batch, vdtype,
    #  bdtype, stream)
    launch = _build.load("coo_spmm", "coo_spmm_launch",
                         "ppppp" "iiiiiii" "ii" "p")
    _build.check(launch(
        vals2.data_ptr(), cols2.data_ptr(), roff2.data_ptr(), b.data_ptr(),
        out.data_ptr(), mb, e, block_rows, m, k, n, batch,
        DTYPE_CODES[vals2.dtype], DTYPE_CODES[b.dtype],
        _build.stream_ptr(b)), "coo_spmm")
    spmm_coo_cuda.launches += 1
    return out


spmm_coo_cuda.launches = 0
