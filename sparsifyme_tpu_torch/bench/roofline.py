"""Per-shape bounds for the sparse-vs-dense sweep on an H100.

Counterpart of ``sparsifyme_tpu.bench.roofline`` with an ``H100`` machine
in place of the TPU's. Each bound is the least time the card could take
for the same work: the larger of the operations over the peak rate for
their type and the bytes that must move (each input read once, each
output written once) over the device-memory bandwidth. Times are for the
bf16 sweep (2 bytes per dense element), except :func:`coo_spmm_work`'s,
whose products run in f32 on the CUDA cores.

:func:`measure_machine` measures this card's achieved rates; ``H100``
(the data sheet) stays the default machine of every bound, so that no
published bound moves with a measurement. ``python -m
sparsifyme_tpu_torch.bench.roofline`` prints the measured rates beside
the data sheet's (needs a card).
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
from typing import Dict


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


def pack_wg_sol_ms(m: int, k: int, b: int, mc: Machine = H100) -> float:
    """K3's wgmma_sp operand from the planes (``ops.sparse24.pack_wg``):
    read the planes (1.25 B) and write the packed words (1.125 B) per
    logical element of k padded to 64, the padding the planes carry."""
    kp = -(-k // 64) * 64
    return 2.375 * m * b * kp / (mc.hbm_gbps * 1e9) * 1e3


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


def shape_roofline(m: int, n: int, k: int, b: int,
                   mc: Machine = H100) -> Dict[str, float]:
    """Each format's bound at one shape, and its speedup over the dense
    bound (not over a measured dense time)."""
    d = dense_sol_ms(m, n, k, b, mc)
    s24 = spmm24_sol_ms(m, n, k, b, mc)
    ell = ell_sol_ms(m, n, k, b, mc)
    return {
        "dense_sol_ms": d,
        "spmm24_sol_ms": s24,
        "ell_sol_ms": ell,
        "spmm24_sol_speedup": d / s24,
        "ell_sol_speedup": d / ell,
    }


def measure_machine(device=None, n: int = 4096,
                    copy_n: int = 8192) -> Machine:
    """This device's achieved rates, timed with ``utils.timing.time_kernel``
    (on the card unless ``device`` says otherwise):

    * ``dense_tflops``: an ``n``-cubed bf16 ``torch.matmul``;
    * ``hbm_gbps``: a bf16 ``copy_n``-square add, counted as JAX counts it
      (two reads and one write);
    * ``f32_tflops``: an ``n``-cubed f32 ``torch.matmul`` with TF32 off
      (the CUDA cores).

    ``sparse24_tflops`` is not measured: it is the data sheet's (``H100``).
    The defaults are the JAX function's sizes; a CPU run may pass small
    ones (its rates are the CPU's)."""
    import torch

    from .._build import resolve_device
    from ..utils.timing import time_kernel

    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(0)

    def normal(size, dtype):
        return torch.randn((size, size), generator=gen, device=dev,
                           dtype=torch.float32).to(dtype)

    bf16 = torch.bfloat16
    t = time_kernel(torch.matmul, (normal(n, bf16), normal(n, bf16)))
    dense = 2.0 * n ** 3 / (t.ms * 1e9)
    big = normal(copy_n, bf16)
    t = time_kernel(torch.add, (big, big + 1))
    hbm = 3.0 * big.numel() * big.element_size() / (t.ms * 1e6)
    del big
    precision = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")  # no TF32
    try:
        t = time_kernel(torch.matmul, (normal(n, torch.float32),
                                       normal(n, torch.float32)))
    finally:
        torch.set_float32_matmul_precision(precision)
    f32 = 2.0 * n ** 3 / (t.ms * 1e9)
    return Machine(dense_tflops=dense, sparse24_tflops=H100.sparse24_tflops,
                   hbm_gbps=hbm, f32_tflops=f32)


def machine_report(mc: Machine) -> Dict[str, Dict[str, object]]:
    """Each rate measured beside the data sheet's and its share of it."""
    out = {}
    for field in dataclasses.fields(Machine):
        got, sheet = getattr(mc, field.name), getattr(H100, field.name)
        measured = field.name != "sparse24_tflops"
        out[field.name] = {
            "measured": got if measured else "not measured",
            "data_sheet": sheet,
            "share": got / sheet if measured else None,
        }
    return out


if __name__ == "__main__":
    import torch

    measured = measure_machine()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    print(json.dumps({"device": torch.cuda.get_device_name(0), "card": card,
                      "machine": machine_report(measured)}))
