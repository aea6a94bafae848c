"""Faults planted in DeepSeek-V3's own mechanisms (the group-limited
router, the routed weights' scale, the shared expert, MLA's interleaved
RoPE and its YaRN softmax scale), each run through the harness like a run
of the cell (set-up, a short window, the comparison of the last pass), so
that each reads ``correct`` false at the cell's own size. The benchmark's
own runs never run this::

    python3 -m perfbench.faults_dsv3 --workload <cell> --seeds <n> ... [--faults <name> ...]

Prints one JSON line a (fault, seed): ``correct`` and the checks. The
route must drive ``models/moe_transformer.py``'s ``moe_route`` and
``moe_shared`` and ``models/mla.py``'s ``mla_attention`` through their
modules (as ``model_routes/dsv3mla24.py`` does).
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


def _rotate_half(y, cos, sin):
    """Rotate-half RoPE in place on ``y [..., seq, 2r]``: the pairs (j, j
    + r), not the source's (2j, 2j + 1)."""
    import torch
    half = y.shape[-1] // 2
    r = y.float()
    a, b = r[..., :half], r[..., half:]
    y.copy_(torch.cat((a * cos - b * sin, b * cos + a * sin), dim=-1))
    return y


FAULTS = ["group_limit_left_out", "shared_expert_skipped",
          "routed_scale_left_out", "rotate_half", "mscale_left_out"]


@contextlib.contextmanager
def planted(fault: str):
    """``fault`` planted in the model's modules while the block runs."""
    from sparsifyme_tpu_torch.models import mla
    from sparsifyme_tpu_torch.models import moe_transformer as mt
    saved = [(mt, "moe_route", mt.moe_route),
             (mt, "moe_shared", mt.moe_shared),
             (mla, "rope_pairs", mla.rope_pairs),
             (mla, "softmax_scale", mla.softmax_scale)]
    real_route = mt.moe_route

    def route_with(**fields):
        return lambda p, h, config: real_route(
            p, h, dataclasses.replace(config, **fields))

    def skipped(p, h, d):
        d.normed = None
        return h

    def unscaled(config):
        return (config.qk_nope_head_dim + config.qk_rope_head_dim) ** -0.5

    try:
        if fault == "group_limit_left_out":
            mt.moe_route = route_with(n_group=1, topk_group=1)
        elif fault == "routed_scale_left_out":
            mt.moe_route = route_with(routed_scaling_factor=None)
        elif fault == "shared_expert_skipped":
            mt.moe_shared = skipped
        elif fault == "rotate_half":
            mla.rope_pairs = _rotate_half
        elif fault == "mscale_left_out":
            mla.softmax_scale = unscaled
        else:
            raise KeyError(fault)
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


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
    kind = torch.cuda.get_device_name(0)
    for fault in args.faults:
        job = {"workload": cell.name, "root": str(ROOT), "seeds": args.seeds,
               "seconds": args.seconds, "trace": False, "t0": time.time(),
               "device": "cuda", "timeout_s": 3000}
        with planted(fault):
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
