"""The MoE combine kernel against its plain version at MiMo-V2-Flash's
shape.

One card of MiMo-V2-Flash's TP8/EP8 prefill combines 32768 tokens of
hidden 4096 a MoE layer, each token choosing 8 of 256 experts of which the
card holds 32. :func:`operands` makes a layer's combine operands the way the
model does: the residual stream, :func:`~..models.moe_transformer.moe_route`'s
dispatch on a random router (so the slot map and the rows' order are the
route's own), and random bf16 expert rows. :func:`measure` holds
:func:`~..ops.kernels.moe_kernel.moe_combine_cuda` to
:func:`~..ops.kernels.moe_kernel.moe_combine_plain` (bit for bit on the
tokens with at most one held choice) and gives both device times beside
the least time: h read and the output written once in float32, each held
row of y, its weight and the slot map read once, at 3.35 TB/s. The plain
version is also the library's yardstick: the four PyTorch calls that
combined before the kernel.

A measurement script: the port does not import it.

Usage (needs one GPU and ``nvcc``)::

    python -m sparsifyme_tpu_torch.bench.moe_combine [--iters 20]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from types import SimpleNamespace
from typing import Sequence

import torch

from ..models import moe_transformer as mt
from ..ops.kernels import moe_kernel
from ..utils.timing import time_graph, time_kernel
from . import roofline

MIMO = dict(tokens=32768, hidden=4096, experts=256, held=32, top=8)


def operands(tokens: int, hidden: int, experts: int, held: int, top: int,
             device, seed: int = 0, empty: Sequence[int] = ()):
    """``(h, d, y)``: the residual stream ``[hidden, tokens]`` float32, the
    dispatch of a router of random bf16 weights over ``experts`` experts
    (the first ``held`` held here; held experts ``empty`` biased below
    every score, so no token chooses them) and random expert rows ``y
    [rows, hidden]`` bf16 in its order."""
    g = torch.Generator(device=device).manual_seed(seed)
    h = torch.randn((hidden, tokens), generator=g, device=device)
    router = torch.randn((experts, hidden), generator=g, device=device)
    bias = torch.zeros(experts, device=device)
    bias[list(empty)] = -100.0
    local = torch.full((experts,), -1, dtype=torch.int64, device=device)
    local[:held] = torch.arange(held, device=device)
    p = mt.Moe(norm=torch.ones(hidden, dtype=mt.BF16, device=device),
               router=router.mul_(hidden ** -0.5).to(mt.BF16), bias=bias,
               experts=[None] * held, local=local)
    config = SimpleNamespace(layernorm_epsilon=1e-5, norm_topk_prob=True,
                             num_experts_per_tok=top, n_group=1,
                             routed_scaling_factor=None)
    _, d = mt.moe_route(p, h, config)
    y = torch.randn((d.index.shape[0], hidden), generator=g,
                    device=device).to(mt.BF16)
    return h, d, y


def least_ms(tokens: int, hidden: int, rows: int, top: int) -> float:
    """The combine's least time on the H100: h read and out written in
    float32, ``rows`` held rows of y in bf16 and their weights, the slot
    map, at 3.35 TB/s."""
    byts = 8 * hidden * tokens + rows * (2 * hidden + 4) + 4 * tokens * top
    return byts / (roofline.H100.hbm_gbps * 1e9) * 1e3


def measure(iters: int = 20, seed: int = 0) -> dict:
    """The kernel against the plain version at MiMo's shape on the card:
    their largest difference and both device ms; raises where a call does
    not count one launch, the kernel moves h, differs on a token with at
    most one held choice, or is more than 1e-6 off elsewhere."""
    h, d, y = operands(**MIMO, device="cuda", seed=seed)
    keep, before = h.clone(), moe_kernel.moe_combine_cuda.launches
    got = moe_kernel.moe_combine_cuda(h, d.slot, d.weight, y)
    if moe_kernel.moe_combine_cuda.launches != before + 1:
        raise AssertionError("moe_combine: the call did not count one launch")
    want = moe_kernel.moe_combine_plain(h, d.index, d.weight, y)
    one = (d.slot >= 0).sum(1) <= 1
    if not torch.equal(h, keep):
        raise AssertionError("moe_combine: the kernel wrote h")
    if not torch.equal(got[:, one], want[:, one]):
        raise AssertionError("moe_combine: not bit for bit on the tokens "
                             "with at most one held choice")
    rel = float((got - want).abs().max() / want.abs().max())
    if not rel <= 1e-6:
        raise AssertionError(f"moe_combine: rel err {rel} > 1e-6")
    del got, want, keep
    ms = time_graph(moe_kernel.moe_combine_cuda, (h, d.slot, d.weight, y),
                    iters=iters, reps=5).ms
    plain_ms = time_kernel(moe_kernel.moe_combine_plain,
                           (h, d.index, d.weight, y), iters=5, reps=3).ms
    rows = sum(d.rows)
    least = least_ms(MIMO["tokens"], MIMO["hidden"], rows, MIMO["top"])
    return {"shape": MIMO, "held_rows": rows,
            "tokens_one_or_none": int(one.sum()), "rel_err": rel,
            "ms": ms, "least_ms": least, "roofline_pct": 100 * least / ms,
            "plain_ms": plain_ms}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("moe_combine: needs a CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True,
                          capture_output=True, text=True).stdout.strip()
    print(f"card: {card}", flush=True)
    print(json.dumps({"moe_combine": measure(args.iters)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
