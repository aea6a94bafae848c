"""Per-shape bounds for the sparse-vs-dense sweep on an H100.

Counterpart of ``sparsifyme_tpu.bench.roofline`` with an ``H100`` machine
in place of the TPU's. Each bound is the least time the card could take
for the same work: the larger of the operations over the peak rate for
their type and the bytes that must move (each input read once, each
output written once) over the device-memory bandwidth. Times are for the
bf16 sweep (2 bytes per dense element), except :func:`coo_spmm_work`'s,
whose products run in f32 on the CUDA cores.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Machine:
    """Peak rates of one card."""

    dense_tflops: float     # dense bf16 tensor-core rate
    sparse24_tflops: float  # 2:4 structured-sparse bf16 tensor-core rate
    hbm_gbps: float         # device-memory bandwidth
    f32_tflops: float       # f32 rate of the CUDA cores (no tensor cores)


H100 = Machine(
    # NVIDIA H100 SXM data sheet: 989 TFLOP/s dense bf16 (without sparsity)
    dense_tflops=989.0,
    # same data sheet: 1,979 TFLOP/s bf16 with 2:4 structured sparsity
    sparse24_tflops=1979.0,
    # same data sheet: 80 GB HBM3 at 3.35 TB/s
    hbm_gbps=3350.0,
    # same data sheet: 67 TFLOP/s FP32 (CUDA cores, without tensor cores)
    f32_tflops=67.0,
)


def _ms(flops: float, tflops: float, byts: float, mc: Machine) -> float:
    return max(flops / (tflops * 1e12), byts / (mc.hbm_gbps * 1e9)) * 1e3


def dense_sol_ms(m: int, n: int, k: int, b: int, mc: Machine = H100) -> float:
    rows = m * b
    return _ms(2.0 * rows * k * n, mc.dense_tflops,
               2.0 * rows * k + 2.0 * k * n + 2.0 * rows * n, mc)


def spmm24_sol_ms(m: int, n: int, k: int, b: int, mc: Machine = H100,
                  packed_codes: bool = False) -> float:
    """Dense-equivalent operations at the 2:4 sparse peak; A at 1.25 B per
    logical element (1.125 with packed codes)."""
    rows = m * b
    a_bpe = 1.125 if packed_codes else 1.25
    return _ms(2.0 * rows * k * n, mc.sparse24_tflops,
               a_bpe * rows * k + 2.0 * k * n + 2.0 * rows * n, mc)


def ell_sol_ms(m: int, n: int, k: int, b: int, mc: Machine = H100,
               density: float = 0.5) -> float:
    """Blocked-ELL skips whole blocks: ``density`` of the operations and
    of the A bytes."""
    rows = m * b
    return _ms(2.0 * rows * k * n * density, mc.dense_tflops,
               2.0 * rows * k * density + 2.0 * k * n + 2.0 * rows * n, mc)


def prune_sol_ms(m: int, k: int, b: int, mc: Machine = H100) -> float:
    """N:M prune: read the input, write pruned values and mask (6 B per
    element)."""
    return 6.0 * m * b * k / (mc.hbm_gbps * 1e9) * 1e3


def compress_sol_ms(m: int, k: int, b: int, mc: Machine = H100) -> float:
    """2:4 compress: read 2 B, write two value planes and codes (1.25 B)
    per element."""
    return 3.25 * m * b * k / (mc.hbm_gbps * 1e9) * 1e3


def fused_sol_ms(m: int, k: int, b: int, mc: Machine = H100) -> float:
    """Fused prune+compress: one dense read (2 B) plus the compact writes
    (1.25 B) per element, the same 3.25 B as :func:`compress_sol_ms`. The
    JAX bound adds a ranking term for the TPU's vector unit; on the H100
    the magnitude ranking (a few compares per element on the CUDA cores)
    has no engine term that binds, so the bound equals the compress
    bound."""
    return compress_sol_ms(m, k, b, mc)


def coo_spmm_work(nnz: int, slots: int, m: int, k: int, n: int, batch: int,
                  b_itemsize: int = 2):
    """``(operations, bytes)`` of segmented COO SpMM (K6) over ``batch`` B
    of ``[k, n]``: ``2 * nnz * batch * n`` f32 operations, for the CUDA
    cores' rate (``f32_tflops``); B read once, C written once in f32 and 12
    bytes (value, column, row offset) per packed slot."""
    flops = 2.0 * nnz * batch * n
    byts = (float(b_itemsize) * batch * k * n + 4.0 * batch * m * n
            + 12.0 * slots)
    return flops, byts


def bound_by(flops: float, tflops: float, byts: float,
             mc: Machine = H100) -> str:
    """Which of the two terms sets a bound: ``"operations"`` or
    ``"bytes"``."""
    ops_s = flops / (tflops * 1e12)
    return "operations" if ops_s >= byts / (mc.hbm_gbps * 1e9) else "bytes"
