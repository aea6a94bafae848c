"""Frozen roofline arithmetic: the H100's sheet peaks and the operations
and bytes each path must move, counted from shapes alone.

Counts are of the work the format needs, never of what one implementation
reads: a 2:4 operand is its kept values plus 2-bit metadata (1.125 B a
logical bf16 element), whatever planes a kernel keeps. Each input byte is
read once and each output byte written once.
"""

from __future__ import annotations

from typing import Tuple

# NVIDIA H100 SXM data sheet, dense rates, at the full 700 W power limit
PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12

BF16 = 2
SP24_BYTES_PER_ELEMENT = 1.125  # half the values (2 B) + 2 bits a group
INDEX_BYTES = 4  # int32 block-column index


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the chip could take: the larger of the operations at
    the bf16 peak and the bytes at HBM bandwidth."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / HBM_BYTES_PER_S)


def kept_flops_24(rows: int, n: int, k: int) -> float:
    """Products a 2:4 operand keeps: 2 * rows * n * k / 2."""
    return float(rows) * n * k


def spmm24_bytes(rows: int, n: int, k: int) -> float:
    """A as the 2:4 format's minimum, B read once, C written once (bf16)."""
    return (rows * k * SP24_BYTES_PER_ELEMENT + k * n * BF16
            + rows * n * BF16)


def pipeline24_bytes(rows: int, n: int, k: int) -> float:
    """The prune -> compress -> matmul pipeline's work whatever implements
    it: dense A read once, B read once, C written once."""
    return rows * k * BF16 + k * n * BF16 + rows * n * BF16


def ell_geometry(ell: dict, k: int) -> Tuple[int, int, int, int]:
    """A Blocked-ELL traffic's ``(block_size, block_k, padded k, blocks
    kept a block-row)`` at contraction ``k``: block_k by the traffic's rule
    on k (the first ``[below, edge]`` with ``k < below``, ``below`` null
    for the rest), k zero-padded to an even number of block_k blocks, and
    ``keep_share`` of those kept (at least one)."""
    bk = next(edge for below, edge in ell["block_k_rule"]
              if below is None or k < below)
    kp = ell_padded_k(k, bk)
    return (ell["block_size"], bk, kp,
            max(1, int((kp // bk) * ell["keep_share"])))


def ell_padded_k(k: int, block_k: int) -> int:
    return -(-k // (2 * block_k)) * 2 * block_k


def ell_flops(rows: int, n: int, kept_cols: int) -> float:
    return 2.0 * rows * n * kept_cols


def ell_bytes(rows: int, n: int, kp: int, kept_cols: int, block_size: int,
              block_k: int) -> float:
    """Kept blocks' values and their column indices, B as the call takes
    it (``kp`` rows, k padded), C written once."""
    indices = (rows // block_size) * (kept_cols // block_k) * INDEX_BYTES
    return (rows * kept_cols * BF16 + indices + kp * n * BF16
            + rows * n * BF16)


def ring24_bytes(rows: int, n: int, k: int) -> float:
    """One rank's ring: its A at the 2:4 minimum, every B shard (all of B,
    k padded to 64 as the planes are), its C rows written once."""
    kp = -(-k // 64) * 64
    return rows * k * SP24_BYTES_PER_ELEMENT + kp * n * BF16 + rows * n * BF16


def pass_kept_flops(traffic: dict, layers) -> float:
    """The products a pass's sparse format keeps on one card, over
    ``(rows, n, k)`` layers."""
    if traffic["route"] == "ell":
        total = 0.0
        for rows, n, k in layers:
            bs, bk, kp, kept = ell_geometry(traffic["ell"], k)
            total += ell_flops(rows, n, kept * bk)
        return total
    return sum(kept_flops_24(rows, n, k) for rows, n, k in layers)
