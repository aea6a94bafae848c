"""Sparse matrix containers as frozen dataclasses of tensors.

Counterparts of ``sparsifyme_tpu.containers`` with the same on-wire
formats, field for field, so operands convert losslessly between the two
packages (see :mod:`.convert`):

* :class:`Sparse24` — 2:4 structured sparsity along the contraction axis,
  stored as k-major, batch-folded planes ``values0``/``values1``/``codes``
  of shape ``[k4, M]`` (``M = prod(batch) * m``; k padded to a multiple of
  64, so ``k4`` is a multiple of 16; codes are uint8 ``i0 * 4 + i1``), or
  row-folded ``[2*k4, M/2]`` with ``fold=2``.
* :class:`BlockedEll` — ``ell_blocks`` kept dense blocks per block-row:
  values ``[..., m, ell_blocks * block_k]`` and int32 ``col_indices``
  ``[..., m_blocks, ell_blocks]``, sorted ascending per block-row.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch


@dataclasses.dataclass(frozen=True)
class Sparse24:
    """2:4-compressed matrix of logical shape ``(..., m, k)``.

    Fields:
      values0: ``[k4, M]`` — first kept value of each group (lower index).
      values1: ``[k4, M]`` — second kept value (higher index).
      codes:   ``[k4, M]`` uint8 — ``i0 * 4 + i1`` with ``0 <= i0 < i1 < 4``.
      shape:   the logical (unpadded) dense shape, batch dims included.
      fold:    row-fold factor of the plane layout. ``fold=2`` planes are
               ``[2*k4, M/2]``: column ``j`` holds original row ``2j`` in
               plane rows ``[0, k4)`` and row ``2j+1`` in ``[k4, 2*k4)``
               (the compress of the free ``[M, kp] -> [M/2, 2*kp]``
               reshape).
    """

    values0: torch.Tensor
    values1: torch.Tensor
    codes: torch.Tensor
    shape: Tuple[int, ...] = ()
    fold: int = 1

    @property
    def dtype(self) -> torch.dtype:
        return self.values0.dtype

    @property
    def k4(self) -> int:
        return self.values0.shape[-2] // self.fold

    @property
    def nnz(self) -> int:
        return self.values0.numel() * 2

    def nbytes(self) -> int:
        return (
            self.values0.numel() * self.values0.element_size()
            + self.values1.numel() * self.values1.element_size()
            + self.codes.numel()
        )


@dataclasses.dataclass(frozen=True)
class BlockedEll:
    """Blocked-ELL matrix: ``ell_blocks`` kept dense blocks per block-row.

    Fields:
      values:      ``(..., m, ell_blocks * block_k)`` — kept blocks packed
                   along the column axis, row-major within a block-row.
      col_indices: ``(..., m_blocks, ell_blocks)`` int32 — block-column of
                   each kept block, in units of ``block_k``-wide blocks.
      shape:       logical dense shape.
      block_size:  block row-edge.
      block_k:     block column-edge; 0 means square (= block_size).
    """

    values: torch.Tensor
    col_indices: torch.Tensor
    shape: Tuple[int, ...] = ()
    block_size: int = 128
    block_k: int = 0

    @property
    def bk(self) -> int:
        """Effective block column-edge."""
        return self.block_k or self.block_size

    @property
    def dtype(self) -> torch.dtype:
        return self.values.dtype

    @property
    def ell_blocks(self) -> int:
        return self.col_indices.shape[-1]

    @property
    def m_blocks(self) -> int:
        return self.col_indices.shape[-2]

    @property
    def k_blocks(self) -> int:
        return self.shape[-1] // self.bk

    @property
    def nnz(self) -> int:
        return self.values.numel()

    def nbytes(self) -> int:
        return (
            self.values.numel() * self.values.element_size()
            + self.col_indices.numel() * self.col_indices.element_size()
        )
