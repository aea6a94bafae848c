"""Faults planted in a MoE model cell's expert layer, each run through the
harness like a run of the cell (set-up, a short window, the comparison of
the last pass), so that each reads ``correct`` false at the cell's own
size. The benchmark's own runs never run this::

    python3 -m perfbench.faults --workload <cell> --seeds <n> ... [--faults <name> ...]

Prints one JSON line a (fault, seed): ``correct`` and the checks. The
route must drive ``sparsifyme_tpu_torch.models.moe_transformer``'s
``moe_route`` and ``moe_experts`` through the module (as
``model_routes/mimo24.py`` does).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time

from . import harness
from .run import CACHES, ROOT


def _first(count, layers):
    return count % layers == 0  # the first MoE layer of a pass


def _zeroed(y, d, rows):
    """``y`` with the rows ``rows(s0, s1, real)`` of each expert zeroed."""
    y = y.clone()
    for (s0, s1), real in zip(d.bounds, d.rows):
        y[rows(s0, s1, real)] = 0
    return y


def _skip_layer(y, d, count, layers):
    return y.new_zeros(y.shape) if _first(count, layers) else y


def _drop_expert(y, d, count, layers):
    s0, s1 = d.bounds[0]
    return _zeroed(y, d, lambda a, b, real: slice(s0, s1))


def _drop_expert_once(y, d, count, layers):
    return _drop_expert(y, d, count, layers) if _first(count, layers) else y


def _half_rows(y, d, count, layers):
    return _zeroed(y, d, lambda s0, s1, real: slice(s0 + real // 2,
                                                     s0 + real))


# what each fault does to moe_experts' output (each expert's rows in
# Dispatch order), given the dispatch, the call's count and the MoE
# layers a pass
EXPERT_FAULTS = {
    "layer_skipped": _skip_layer,  # the first MoE layer adds nothing
    "expert_dropped": _drop_expert,  # held expert 0 adds nothing, anywhere
    "expert_dropped_once": _drop_expert_once,  # ... in the first MoE layer
    "half_rows": _half_rows,  # the later half of each expert's real rows
}
FAULTS = sorted(EXPERT_FAULTS) + ["bias_left_out"]  # the router's bias


@contextlib.contextmanager
def planted(fault: str, layers: int):
    """``fault`` planted in the model module while the block runs;
    ``layers`` MoE layers a pass."""
    from sparsifyme_tpu_torch.models import moe_transformer as mt
    real_experts, real_route = mt.moe_experts, mt.moe_route
    calls = [0]

    def experts(p, x, d):
        y = EXPERT_FAULTS[fault](real_experts(p, x, d), d, calls[0], layers)
        calls[0] += 1
        return y

    def route(p, h, config):
        return real_route(dataclasses.replace(
            p, bias=p.bias.new_zeros(p.bias.shape)), h, config)

    try:
        if fault == "bias_left_out":
            mt.moe_route = route
        else:
            mt.moe_experts = experts
        yield
    finally:
        mt.moe_experts, mt.moe_route = real_experts, real_route


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--faults", nargs="+", default=FAULTS, choices=FAULTS)
    p.add_argument("--seconds", type=float, default=1.0)
    args = p.parse_args(argv)
    for var, sub in CACHES.items():
        os.environ[var] = str(ROOT / ".perfbench_cache" / sub)
    cell = harness.load_cell(args.workload, ROOT)
    import torch
    if not torch.cuda.is_available() or cell.chips != 1:
        harness.log(f"{cell.name}: one CUDA card and a one-card cell")
        return 2
    layers = sum(1 for f in cell.config["moe_layer_freq"] if f)
    kind = torch.cuda.get_device_name(0)
    for fault in args.faults:
        job = {"workload": cell.name, "root": str(ROOT), "seeds": args.seeds,
               "seconds": args.seconds, "trace": False, "t0": time.time(),
               "device": "cuda", "timeout_s": 3000}
        with planted(fault, layers):
            runs = harness.run_job(job)
        for seed, ranks in zip(args.seeds, runs):
            line = harness.result_line(cell, ranks, False, "cuda", kind)
            print(json.dumps({"fault": fault, "seed": seed,
                              "correct": line["correct"],
                              "checks": line["checks"]}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
