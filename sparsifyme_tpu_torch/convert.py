"""numpy-in / numpy-out converters for the sparse containers.

They bring operands built by another framework (the JAX package, in the
tests) into the port, and the port's results back, through plain numpy
arrays. bfloat16 arrays are recognised by their dtype name (as numpy
extension dtypes name it) and carried bit for bit; on the way out a
bfloat16 tensor becomes float32, which holds every bfloat16 value exactly.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ._build import resolve_device
from .containers import BlockedEll, Sparse24


def tensor_from_numpy(arr, device=None) -> torch.Tensor:
    arr = np.array(arr, copy=True, order="C")  # own, writable memory
    dev = resolve_device(device)
    if arr.dtype.name == "bfloat16":
        bits = torch.from_numpy(arr.view(np.uint16).astype(np.int16))
        return bits.view(torch.bfloat16).to(dev)
    return torch.from_numpy(arr).to(dev)


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def sparse24_from_numpy(values0, values1, codes, shape, fold: int = 1,
                        device=None) -> Sparse24:
    return Sparse24(
        values0=tensor_from_numpy(values0, device),
        values1=tensor_from_numpy(values1, device),
        codes=tensor_from_numpy(np.asarray(codes, np.uint8), device),
        shape=tuple(int(d) for d in shape),
        fold=fold,
    )


def sparse24_to_numpy(s: Sparse24) -> Tuple[np.ndarray, np.ndarray,
                                             np.ndarray, Tuple[int, ...], int]:
    """``(values0, values1, codes, shape, fold)``."""
    return (tensor_to_numpy(s.values0), tensor_to_numpy(s.values1),
            tensor_to_numpy(s.codes), tuple(s.shape), s.fold)


def blocked_ell_from_numpy(values, col_indices, shape, block_size: int,
                           block_k: int = 0, device=None) -> BlockedEll:
    return BlockedEll(
        values=tensor_from_numpy(values, device),
        col_indices=tensor_from_numpy(np.asarray(col_indices, np.int32),
                                      device),
        shape=tuple(int(d) for d in shape),
        block_size=int(block_size),
        block_k=int(block_k),
    )


def blocked_ell_to_numpy(e: BlockedEll) -> Tuple[np.ndarray, np.ndarray,
                                                  Tuple[int, ...], int, int]:
    """``(values, col_indices, shape, block_size, block_k)``."""
    return (tensor_to_numpy(e.values), tensor_to_numpy(e.col_indices),
            tuple(e.shape), e.block_size, e.block_k)
