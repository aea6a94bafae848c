"""Headline benchmark on the GPU: ResNet-50 sparse-vs-dense sweep.

Prints ONE JSON line in the schema of the JAX package's ``bench.py``: the
geometric-mean paired speedup of the best sparse format per layer
(Blocked-ELL at 50% block sparsity or 2:4) over the dense bf16 baseline.
Runs on the GPU; ``--cpu`` runs the plain versions on the CPU as a
surface check whose timings mean nothing.

Usage: python -m sparsifyme_tpu_torch.bench [--model resnet50] [--quick]
           [--kernels gemm,prune,spmm24,ell] [--csv PATH] [--cpu]
"""

import argparse
import json
import sys

from .harness import headline, run_model_sweep


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--model", default="resnet50")
    p.add_argument("--quick", action="store_true",
                   help="first 8 layers only (smoke test)")
    p.add_argument("--kernels", default="gemm,prune,spmm24,ell")
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--csv", default=None)
    p.add_argument("--compare-csv", default=None)
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (surface check; timings are not "
                        "meaningful)")
    args = p.parse_args()
    _, summary = run_model_sweep(
        args.model,
        kernels=tuple(args.kernels.split(",")),
        iters=args.iters,
        reps=args.reps,
        csv_path=args.csv,
        compare_csv_path=args.compare_csv,
        max_layers=8 if args.quick else None,
        device="cpu" if args.cpu else None,
        verbose=True,
    )
    for k, v in sorted(summary.items()):
        print(f"# {k}: {v}", file=sys.stderr)
    where = ("CPU surface check, not a device measurement" if args.cpu
             else "1 GPU (H100)")
    print(json.dumps(headline(args.model, summary, where)), flush=True)


if __name__ == "__main__":
    main()
