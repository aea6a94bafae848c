"""Strided-batched COO SpMM: one sparse A shared by a batch of dense B.

Counterpart of ``sparsifyme_tpu.ops.coo`` (the reference's
``batched::strided_coo``, ``spmm.hxx:140-193``, whose stride-0
``cusparseCooSetStridedBatch`` shares A across the batch).
:func:`spmm_coo_segmented` runs kernel K6 on CUDA tensors and its plain
version on CPU tensors. :func:`spmm_coo`, the gather/segment-sum oracle,
is plain PyTorch on either device, as the JAX op is plain XLA. Building
the format and converting it to Blocked-ELL are host-side, data-dependent
steps, as in the JAX package; their cost is what BASELINE config 2 times
as ``conversion_ms``.

``coo_to_ell`` pads the unused slots of a block-row with block column 0,
so its output can repeat a column: :func:`~.ell.spmm_ell` sums repeated
slots and gives the right product, :func:`~.ell.spmm_ell_expand` keeps the
last slot and does not. Send ``coo_to_ell`` output to ``spmm_ell`` only
(both packages behave the same; ``ROADMAP.md`` section C).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from .. import _build
from ..containers import BlockedEll, Coo
from ..convert import tensor_from_numpy, tensor_to_numpy
from .kernels.coo_kernel import (pack_coo_blockrows, spmm_coo_cuda,
                                 spmm_coo_plain)

GATHERS = ("auto", "matmul", "slices")


def coo_from_dense(w, nnz: Optional[int] = None, *, device=None) -> Coo:
    """Build a Coo from a dense ``(m, k)`` matrix, entries in row-major
    order (as ``np.nonzero``), padded to ``nnz`` with explicit zeros at
    (0, 0) if asked.

    A tensor keeps its device; a numpy array goes to ``device`` (``None``
    is the GPU, as every entry point of the port).
    """
    if isinstance(w, torch.Tensor):
        m, k = w.shape
        rows, cols = torch.nonzero(w, as_tuple=True)
        vals = w[rows, cols]
        rows, cols = rows.to(torch.int32), cols.to(torch.int32)
    else:
        wn = np.asarray(w)
        m, k = wn.shape
        r, c = np.nonzero(wn)
        vals = tensor_from_numpy(wn[r, c], device)
        rows = tensor_from_numpy(r.astype(np.int32), device)
        cols = tensor_from_numpy(c.astype(np.int32), device)
    if nnz is not None:
        pad = nnz - vals.numel()
        if pad < 0:
            raise ValueError(f"nnz {nnz} < actual nonzeros {vals.numel()}")
        rows = torch.cat([rows, rows.new_zeros(pad)])
        cols = torch.cat([cols, cols.new_zeros(pad)])
        vals = torch.cat([vals, vals.new_zeros(pad)])
    return Coo(rows=rows, cols=cols, values=vals, shape=(int(m), int(k)))


def spmm_coo(a: Coo, b: torch.Tensor, *, out_dtype=None,
             batch_chunk: Optional[int] = None) -> torch.Tensor:
    """``C[..., m, n] = A @ B[..., k, n]`` with A shared across the batch.

    Gathers the rows of B at A's columns, scales them by A's values and
    sums them into C's rows, in f32 whatever the operand types (the oracle
    of K6). ``batch_chunk`` processes the flattened batch in sequential
    chunks of that size: the gather holds a ``[chunk, nnz, n]`` f32
    intermediate, which at low sparsity would not fit unchunked.
    """
    m, k = a.shape
    *lead, kb, n = b.shape
    if kb != k:
        raise ValueError(f"A is {a.shape} but b has {kb} rows")
    out_dtype = out_dtype or torch.promote_types(a.dtype, b.dtype)
    b3 = b.reshape(-1, k, n)
    bsz = b3.shape[0]
    chunk = batch_chunk if (batch_chunk and lead) else max(bsz, 1)
    if bsz % chunk:
        raise ValueError(f"batch {bsz} not divisible by batch_chunk {chunk}")
    rows, cols = a.rows.long(), a.cols.long()
    vals = a.values.to(torch.float32)[:, None]
    out = torch.zeros((bsz, m, n), dtype=torch.float32, device=b.device)
    for i in range(0, bsz, chunk):
        gathered = b3[i:i + chunk].index_select(1, cols).float() * vals
        out[i:i + chunk].index_add_(1, rows, gathered)
    return out.reshape(*lead, m, n).to(out_dtype)


def coo_to_dense(a: Coo) -> torch.Tensor:
    return a.todense()


def coo_to_ell(a: Coo, block_size: int,
               ell_blocks: Optional[int] = None) -> BlockedEll:
    """Convert to Blocked-ELL with square ``block_size`` blocks, host-side;
    the result lies on ``a``'s device.

    ``ell_blocks`` defaults to the most occupied blocks of a block-row and
    raises if a block-row needs more. Unused slots keep block column 0
    (so a column can repeat; see the module note) and zero values, and
    explicit zeros of ``a`` are dropped, as in the JAX op.
    """
    m, k = a.shape
    bs = block_size
    if m % bs or k % bs:
        raise ValueError(f"{a.shape} not divisible by block_size {bs}")
    mb = m // bs
    rows = tensor_to_numpy(a.rows).astype(np.int64)
    cols = tensor_to_numpy(a.cols).astype(np.int64)
    vals = tensor_to_numpy(a.values)
    keep = vals != 0
    rows, cols, vals = rows[keep], cols[keep], vals[keep]
    brow, bcol = rows // bs, cols // bs
    occupied = [np.unique(bcol[brow == r]) for r in range(mb)]
    need = max((len(o) for o in occupied), default=0) or 1
    if ell_blocks is None:
        ell_blocks = need
    elif need > ell_blocks:
        raise ValueError(f"need {need} blocks/row > ell_blocks {ell_blocks}")
    values = np.zeros((m, ell_blocks * bs), vals.dtype)
    col_indices = np.zeros((mb, ell_blocks), np.int32)
    for r in range(mb):
        occ = occupied[r]
        col_indices[r, :len(occ)] = occ
        slot_of = {c: j for j, c in enumerate(occ)}
        sel = brow == r
        rr, cc, vv = rows[sel], cols[sel], vals[sel]
        j = np.array([slot_of[c] for c in cc // bs], np.int64)
        values[rr, j * bs + (cc % bs)] = vv
    dev = a.values.device
    return BlockedEll(
        values=tensor_from_numpy(values, dev).to(a.values.dtype),
        col_indices=tensor_from_numpy(col_indices, dev),
        shape=(m, k), block_size=bs)


def pack_coo(a: Coo, block_rows: int = 128
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The ``(vals2, cols2, roff2)`` planes that K6 reads, on ``a``'s
    device: the format-build step, kept out of the timed call."""
    return pack_coo_blockrows(a.rows, a.cols, a.values, a.shape[0],
                              block_rows=block_rows)


def spmm_coo_segmented(
    a: Coo,
    b: torch.Tensor,
    *,
    out_dtype=None,
    block_rows: int = 128,
    packed: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None,
    gather: str = "auto",
) -> torch.Tensor:
    """Segmented block-row COO SpMM ``A @ B[..., k, n]``: kernel K6 on CUDA
    tensors, its plain version on CPU tensors.

    Entries are packed per block-row of C (:func:`pack_coo`; pass
    ``packed`` to keep that step out of a hot loop) and the batch dims of
    ``b`` share the one A. Accumulation is f32; ``out_dtype`` defaults to
    the promoted type of A and B. ``gather`` names the TPU kernel's
    formulations (``"auto"``, ``"matmul"``, ``"slices"``); all three run
    the same kernel here.
    """
    if gather not in GATHERS:
        raise ValueError(f"gather {gather!r} not one of {GATHERS}")
    m, k = a.shape
    out_dtype = out_dtype or torch.promote_types(a.dtype, b.dtype)
    *lead, kb, n = b.shape
    if kb != k:
        raise ValueError(f"A is {a.shape} but b has {kb} rows")
    if packed is None:
        packed = pack_coo(a, block_rows)
    b3 = b.reshape(math.prod(lead), k, n)
    if _build.use_kernel(b3):
        _build.refuse_grad("spmm_coo_segmented", a.values, b, *packed)
        fn = spmm_coo_cuda
    else:
        fn = spmm_coo_plain
    out = fn(*packed, b3, m=m, block_rows=block_rows)
    return out.reshape(*lead, m, n).to(out_dtype)
