"""K3's ``wgmma_sp`` route on its 256-row unit against its 128-row unit.

At MiMo-V2-Flash's 2:4 products as one card of its TP8/EP8 deployment runs
them (q, o, layer 0's gate_up and down at 32768 tokens; an expert's gate_up
and down at 1024 routed rows), prints the device ms of
:func:`~..ops.kernels.spmm24_kernel.spmm24_wg_cuda` under the 128-row
unit's plan (``wg_forced_plan``, :func:`~..ops.kernels.spmm24_kernel.wg_plan`'s
width and splits) and under ``wg_plan``'s own (the 256-row unit in bands),
the least time (kept products at 989 TFLOP/s or the packed A, B and C at
3.35 TB/s) and what bounds it, whether the two units' outputs are equal
bit for bit at the same width and split count, the plain version's ms
(``spmm24_wg_plain``: the packed words decoded, an f32 product) and the
library's (``torch.matmul`` on the decoded A in bf16, device ms).

``--steps`` times a k-step of each unit and width, the source of
``WG_STEP_US`` and ``WG256_STEP_US``: one split, four waves of units on
132 SMs (12 m-tiles by 44 n-tiles), k 8192, so that B's strips and A's
blocks are shared by the blocks in flight and the tile's mainloop, not
device memory, sets the time; a step is a wave's time less the plan's
epilogue estimate, over its k-steps.

A measurement script: the port does not import it.

Usage (needs one GPU and ``nvcc``)::

    python -m sparsifyme_tpu_torch.bench.wg_tall [--steps] [--iters 10]
"""

from __future__ import annotations

import argparse
import contextlib
import subprocess
import sys

import torch

from ..ops.kernels import ell_kernel as ellk
from ..ops.kernels import spmm24_kernel as k3
from ..ops.kernels.prune_kernel import prune_compress_24_cuda
from ..utils.timing import time_graph, time_kernel
from . import roofline

# (name, M, K, n)
SHAPES = [("q", 1536, 4096, 32768), ("o", 4096, 1024, 32768),
          ("gate_up", 32768, 4096, 32768), ("down", 4096, 16384, 32768),
          ("expert gate_up", 4096, 4096, 1024),
          ("expert down", 4096, 2048, 1024)]


@contextlib.contextmanager
def forced(plan):
    """``spmm24_wg_cuda`` under ``plan`` inside the block."""
    saved = k3.card_wg_plan
    k3.card_wg_plan = lambda *a, **kw: plan
    try:
        yield
    finally:
        k3.card_wg_plan = saved


def _operands(gen, m, k, n):
    a = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
    v0, v1, codes = prune_compress_24_cuda(a)
    del a
    b = torch.randn((k, n), generator=gen, device="cuda").to(torch.bfloat16)
    return k3.pack_wgmma_sp_cuda(v0, v1, codes), b


def _time(plan, packed, b, m, k, iters):
    def call(pk, y):
        return k3.spmm24_wg_cuda(pk, y, m=m, k_logical=k,
                                 out_dtype=torch.bfloat16)
    with forced(plan):
        out = call(packed, b)
        ms = time_graph(call, (packed, b), iters=iters, reps=5).ms
    return ms, out


def shapes(gen, iters: int) -> None:
    print("shape | M x K x n | 128-row plan | ms | 256-row plan | ms | "
          "least ms (by) | TFLOP/s kept 128 / 256 | bit for bit | plain ms | "
          "library ms")
    for name, m, k, n in SHAPES:
        packed, b = _operands(gen, m, k, n)
        tall = k3.wg_plan(m, n, k, k3.sm_count(b.get_device()))
        short = k3.wg_forced_plan(m, n, k, tall.bn, tall.splits,
                                  k3.sm_count(b.get_device()))
        ms_s, out_s = _time(short, packed, b, m, k, iters)
        ms_t, out_t = _time(tall, packed, b, m, k, iters)
        same = torch.equal(out_s, out_t)
        del out_s, out_t
        kw = dict(m=m, k_logical=k, out_dtype=torch.bfloat16)
        plain_ms = time_kernel(lambda pk, y: k3.spmm24_wg_plain(pk, y, **kw),
                               (packed, b), iters=3, reps=3).ms
        dense = k3.wg_dense(packed)[:k].T.to(torch.bfloat16).contiguous()
        lib_ms = time_graph(torch.matmul, (dense, b), iters=iters, reps=5).ms
        del dense
        least = roofline.spmm24_sol_ms(m, n, k, 1, packed_codes=True)
        by = roofline.bound_by(2.0 * m * k * n, roofline.H100.sparse24_tflops,
                               1.125 * m * k + 2.0 * k * n + 2.0 * m * n)
        print(f"{name} | {m} x {k} x {n} | {tuple(short)} | {ms_s:.4f} | "
              f"{tuple(tall)} | {ms_t:.4f} | {least:.4f} ({by}) | "
              f"{m * k * n / ms_s / 1e9:.0f} / {m * k * n / ms_t / 1e9:.0f}"
              f" | {same} | {plain_ms:.4f} | {lib_ms:.4f}", flush=True)
        del packed, b
        torch.cuda.empty_cache()


def steps(gen, iters: int) -> None:
    k = 8192
    print("rows | bn | M x K x n | ms | waves | k-steps | us a k-step")
    for rows in (k3.WG_BM, k3.WG_TALL_BM):
        for bn in (64, 128):
            m, n = 12 * rows, 44 * bn
            packed, b = _operands(gen, m, k, n)
            plan = k3.wg_forced_plan(m, n, k, bn, 1, rows=rows)
            ms, _ = _time(plan, packed, b, m, k, iters)
            waves = -(-plan.units // plan.grid)
            epi_us = rows * bn * 2 / ellk.EPI_BYTES_PER_US
            step = (ms * 1e3 / waves - epi_us) / plan.kps
            print(f"{rows} | {bn} | {m} x {k} x {n} | {ms:.4f} | {waves} | "
                  f"{plan.kps} | {step:.4f}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", action="store_true",
                    help="time a k-step of each unit and width")
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("wg_tall: needs a CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True,
                          capture_output=True, text=True).stdout.strip()
    print(f"card: {card}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    if args.steps:
        steps(gen, args.iters)
    shapes(gen, args.iters)
    return 0


if __name__ == "__main__":
    sys.exit(main())
