"""The reference's example drivers as one Python CLI.

Counterpart of ``sparsifyme_tpu.bench.drivers``. Each reference example
binary prints one elapsed-ms float (``examples/sparsify.cu:54``,
``gemm.cu:97``, ``spmm.cu:118``, ``batched_coo.cu:112``); ``spmma`` prints
three labelled phase times (``examples/spmma.cu:61-66``). Same argv, same
stdout, timed in steady state with CUDA events after a warm-up.

Usage: python -m sparsifyme_tpu_torch.bench.drivers <kernel> m n [k b] [--cpu]
       (kernels: sparsify gemm spmm spmma batched_coo; ``--cpu`` runs the
       plain versions on the CPU, whose times mean nothing on a device)
"""

from __future__ import annotations

import sys

import torch

from .. import _build
from ..utils.timing import time_kernel

KERNELS = ("sparsify", "gemm", "spmm", "spmma", "batched_coo")


def _time(fn, operands, iters=8, reps=3) -> float:
    return time_kernel(fn, operands, iters=iters, reps=reps).ms


def run(kernel: str, m: int, n: int, k: int = 0, b: int = 1,
        device=None) -> None:
    """Run one driver and print its stdout contract; ``device=None`` is
    the GPU."""
    dev = _build.resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(
            torch.bfloat16)

    if kernel == "sparsify":
        # The reference's 2x2 blocks at 50% on an m x n weight
        # (examples/sparsify.cu:43-46), with the magnitude policy.
        from ..ops.prune import prune_block_magnitude

        w0 = prune_block_magnitude(randn(m, n), (2, 2), 0.5)[0]
        ms = _time(lambda x: prune_block_magnitude(x, (2, 2), 0.5), (w0,))
        print(f"{ms:.6f}")

    elif kernel == "gemm":
        from ..ops.gemm import batched_gemm

        a, bm = randn(b, m, k), randn(k, n)
        ms = _time(lambda x, y: batched_gemm(x, y, out_dtype=torch.bfloat16),
                   (a, bm))
        print(f"{ms:.6f}")

    elif kernel == "spmm":
        # Blocked-ELL at 50% block sparsity: m padded to the 128-row
        # block, k to an even number of block_k-wide blocks. stderr names
        # the format measured; stdout keeps the single float.
        from ..ops.ell import ell_from_dense, spmm_ell

        bs = 128
        bkb = 32 if k < 512 else (64 if k < 1536 else 128)
        mp = -(-m // bs) * bs
        kp = -(-k // (2 * bkb)) * (2 * bkb)
        ell_blocks = max(1, (kp // bkb) // 2)
        e = ell_from_dense(randn(b, mp, kp), bs, ell_blocks, bkb)
        bm = randn(kp, n)
        print(f"# format=blocked-ell block={bs}x{bkb} ell_blocks={ell_blocks}"
              f" padded_m={mp} padded_k={kp}", file=sys.stderr)
        print(f"{_time(lambda ee, y: spmm_ell(ee, y), (e, bm)):.6f}")

    elif kernel == "spmma":
        from ..plan import SpmmaConfig, get_plan

        a, bm = randn(b, m, k), randn(k, n)
        plan = get_plan(SpmmaConfig(m=m, n=n, k=k, batch=b))
        _, times = plan.timed(a, bm, iters=8, reps=3)
        print(f"Prune time: {times['prune'].ms:.6f}")
        print(f"Compress time: {times['compress'].ms:.6f}")
        print(f"Matmul time: {times['mul'].ms:.6f}")

    elif kernel == "batched_coo":
        # One shared sparse A over the batch (stride-0 strided batch,
        # spmm.hxx:169), timed through the gather/segment-sum op as in the
        # JAX driver.
        from ..ops.coo import coo_from_dense, spmm_coo
        from ..ops.prune import prune_nm

        pruned = prune_nm(randn(m, k), 2, 4)[0]
        coo = coo_from_dense(pruned, nnz=m * k // 2)
        bm = randn(b, k, n)
        print(f"{_time(lambda cc, y: spmm_coo(cc, y), (coo, bm)):.6f}")

    else:
        raise SystemExit(f"unknown kernel: {kernel}")


def main(argv=None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    device = "cpu" if "--cpu" in argv else None
    argv = [x for x in argv if x != "--cpu"]
    if len(argv) not in (3, 5):
        raise SystemExit(
            "usage: drivers <kernel> m n [k b] [--cpu]  "
            f"(kernels: {' '.join(KERNELS)})")
    nums = [int(x) for x in argv[1:]]
    run(argv[0], *nums, device=device)


if __name__ == "__main__":
    main()
