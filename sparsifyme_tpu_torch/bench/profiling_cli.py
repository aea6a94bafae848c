"""Reference-parity benchmark sweep over the driver CLI.

Counterpart of ``sparsifyme_tpu.bench.profiling_cli``, which re-implements
the reference's ``examples/profiling.py``: one driver process per kernel
and shape, its stdout float parsed, ``compare.csv`` written with the
columns ``layer,m,n,k,b,gemm,prune,spmm`` (``profiling.py:4-44``). Each
driver runs as ``python -m sparsifyme_tpu_torch.bench.drivers <kernel>
...`` in place of the reference's binaries; the kernels are built once
before the first driver starts, and every driver loads them from
``sparsifyme_tpu_torch/_build/``. A driver that fails, or prints no float,
leaves its cell empty, is reported on stderr, and makes :func:`main`
return 1. The in-process harness (:mod:`.harness`) is the measurement
path; this module covers the drivers' CLI contract.

Usage: python -m sparsifyme_tpu_torch.bench.profiling_cli
           [--shapes datasets/shapes.csv] [--out compare.csv] [--limit N]
           [--timeout S] [--bin PYTHON] [--plot PNG] [--cpu]
"""

from __future__ import annotations

import argparse
import csv
import os
import subprocess
import sys
from typing import List, Optional

from .. import _build
from ..utils.shapes import read_shapes

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _run(python: str, args: List, timeout: float,
         cpu: bool) -> Optional[float]:
    """Run one driver and parse the float on the last line of its stdout;
    ``None`` (reported on stderr) where it fails or prints none."""
    cmd = [python, "-m", "sparsifyme_tpu_torch.bench.drivers",
           *map(str, args)] + (["--cpu"] if cpu else [])
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=timeout, env=env, cwd=REPO)
    except subprocess.TimeoutExpired:
        print(f"driver {' '.join(cmd[3:])}: no result in {timeout:.0f} s",
              file=sys.stderr, flush=True)
        return None
    lines = proc.stdout.strip().splitlines()
    try:
        if proc.returncode != 0:
            raise ValueError(f"exit {proc.returncode}")
        return float(lines[-1])
    except (ValueError, IndexError) as exc:
        print(f"driver {' '.join(cmd[3:])}: no float ({exc}); stdout "
              f"{lines[-3:]}; stderr {proc.stderr.strip()[-2000:]}",
              file=sys.stderr, flush=True)
        return None


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--shapes",
                   default=os.path.join(REPO, "datasets", "shapes.csv"))
    p.add_argument("--bin", default=sys.executable,
                   help="the Python that runs the drivers (the reference "
                        "took a directory of driver binaries)")
    p.add_argument("--out", default="compare.csv")
    p.add_argument("--limit", type=int, default=None,
                   help="only the first N shapes")
    p.add_argument("--timeout", type=float, default=600.0,
                   help="seconds per driver process")
    p.add_argument("--plot", default=None, metavar="PNG",
                   help="also render the grouped-bar comparison chart")
    p.add_argument("--cpu", action="store_true",
                   help="pass --cpu to the drivers (plain versions on the "
                        "CPU; their times are not device measurements)")
    args = p.parse_args(argv)

    shapes = read_shapes(args.shapes)
    if args.limit:
        shapes = shapes[:args.limit]
    if not args.cpu:
        _build.build_all()

    rows, failed = [], 0
    for i, s in enumerate(shapes):
        gemm = _run(args.bin, ["gemm", s.m, s.n, s.k, s.b], args.timeout,
                    args.cpu)
        # sparsify takes (m, k): the weight matrix (profiling.py:33)
        prune = _run(args.bin, ["sparsify", s.m, s.k], args.timeout,
                     args.cpu)
        spmm = _run(args.bin, ["spmm", s.m, s.n, s.k, s.b], args.timeout,
                    args.cpu)
        failed += sum(x is None for x in (gemm, prune, spmm))
        rows.append([i, s.m, s.n, s.k, s.b, gemm, prune, spmm])
        print(f"layer {i}: m={s.m} n={s.n} k={s.k} b={s.b} "
              f"gemm={gemm} prune={prune} spmm={spmm}", file=sys.stderr,
              flush=True)

    with open(args.out, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["layer", "m", "n", "k", "b", "gemm", "prune", "spmm"])
        w.writerows(rows)
    print(f"wrote {args.out} ({len(rows)} layers, {failed} drivers "
          "failed)", file=sys.stderr)
    if args.plot:
        from .plots import plot_compare

        plot_compare(args.out, args.plot, series=("gemm", "prune", "spmm"))
        print(f"wrote {args.plot}", file=sys.stderr)
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
