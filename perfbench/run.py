"""The benchmark's command: one run of one cell on the card(s) of this
machine, printing the contract's result as the last line of standard
output::

    python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

It loads, warms up, runs a closed loop of passes for ``--seconds``, checks
the last pass's outputs against the plain reference, and prints the line.
With ``--trace 0`` the line holds the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics. A cell on several chips runs one
process a card, started and waited for by this one. Without the cards the
cell asks for, it exits non-zero and prints no result.
"""

from __future__ import annotations

import time

T0 = time.time()  # set-up is timed from here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# fixed directories inside the checkout, so that only a checkout's first
# run builds or compiles
CACHES = {"TORCH_EXTENSIONS_DIR": "torch_extensions",
          "TRITON_CACHE_DIR": "triton", "CUDA_CACHE_PATH": "cuda"}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    for var, sub in CACHES.items():
        os.environ[var] = str(ROOT / ".perfbench_cache" / sub)

    from . import harness
    cell = harness.load_cell(args.workload, ROOT)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        harness.log(f"{cell.name} needs {cell.chips} CUDA card(s); this "
                    f"machine has {found}. Nothing runs on the CPU.")
        return 2
    job = {"workload": cell.name, "root": str(ROOT), "seeds": [args.seed],
           "seconds": args.seconds, "trace": bool(args.trace), "t0": T0,
           "device": "cuda"}
    ranks = harness.run_job(job)[0]
    bad = sorted(set(harness.forbidden_modules()).union(
        *(r["forbidden"] for r in ranks)))
    if bad:
        harness.log(f"the run loaded {bad}: the benchmark runs the port "
                    "alone")
        return 3
    line = harness.result_line(cell, ranks, bool(args.trace), "gpu",
                               ranks[0]["kind"])
    r0 = ranks[0]
    harness.log(f"{cell.name} seed {args.seed}: {r0['passes']} passes in "
                f"{r0['window_s']:.3f} s; set-up {r0['setup_s']:.3f} s; "
                f"designs {r0['designs']}")
    if "ell_margin" in r0:
        harness.log(f"smallest relative gap at the ELL cut: "
                    f"{min(r.get('ell_margin', 1.0) for r in ranks)!r}")
    if args.trace:
        harness.log("traced spans, rank 0: " + json.dumps(
            r0["trace"]["spans"], sort_keys=True))
    for name, c in line["checks"].items():
        harness.log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
