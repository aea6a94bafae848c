"""Readings that the comparison's limits are set from: the program's on
many seeds, and the control's (the reference one precision down, in the
program's place) on some of them, each at the cell's own size after a
short window. The benchmark's own runs never run this::

    python3 -m perfbench.calibrate --workload <cell> --seeds <n> ... [--control <count>] [--seconds 1]

Prints one JSON line a seed, then the largest program reading and the
smallest control reading of each compared number beside the cell's
limits. Every seed runs in this one process (one process a rank on
several chips).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from . import harness
from .run import CACHES, ROOT

NUMBERS = ("rel_err", "max_err")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control", type=int, default=3,
                   help="how many of the seeds, the first ones, also read "
                        "the control")
    p.add_argument("--seconds", type=float, default=1.0)
    args = p.parse_args(argv)
    for var, sub in CACHES.items():
        os.environ[var] = str(ROOT / ".perfbench_cache" / sub)
    cell = harness.load_cell(args.workload, ROOT)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        harness.log(f"{cell.name} needs {cell.chips} CUDA card(s)")
        return 2
    job = {"workload": cell.name, "root": str(ROOT), "seeds": args.seeds,
           "seconds": args.seconds, "trace": False, "t0": time.time(),
           "device": "cuda", "control_seeds": args.seeds[:args.control],
           "timeout_s": 3000}
    program = {k: [] for k in NUMBERS}
    control = {k: [] for k in NUMBERS}
    for seed, ranks in zip(args.seeds, harness.run_job(job)):
        got = {k: max(r["readings"][k] for r in ranks) for k in NUMBERS}
        row = {"seed": seed, "program": got, "passes": ranks[0]["passes"]}
        for k in NUMBERS:
            program[k].append(got[k])
        if "control" in ranks[0]:
            row["control"] = {k: max(r["control"][k] for r in ranks)
                              for k in NUMBERS}
            for k in NUMBERS:
                control[k].append(row["control"][k])
        if "ell_margin" in ranks[0]:
            row["ell_margin"] = min(r["ell_margin"] for r in ranks)
        print(json.dumps(row), flush=True)
    print(json.dumps({
        "workload": cell.name, "seeds": len(args.seeds),
        "program_max": {k: max(v) for k, v in program.items()},
        "control_min": {k: min(v) if v else None
                        for k, v in control.items()},
        "limits": {k: cell.checks[k] for k in NUMBERS}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
