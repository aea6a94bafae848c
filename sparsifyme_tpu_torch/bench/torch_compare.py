"""PyTorch cross-check: dense matmul against sparse with its conversion.

Counterpart of ``sparsifyme_tpu.bench.torch_compare`` (the reference's
``profiling/python/gemm_coo_compare.py``): for each layer shape, time (a)
the dense product ``torch.matmul(A, B)`` of one ``[m, k]`` A against a
batch of ``b`` B ``[k, n]`` and (b) ``A.to_sparse()`` followed by one
``torch.sparse.mm`` per batch, the conversion timed apart, at a given
density: a sparse-versus-dense comparison must charge the format
conversion. Both sides are PyTorch's own (cuBLAS, cuSPARSE), in f32,
since ``torch.sparse.mm`` on the card takes no bf16; none of the port's
kernels runs here. Times are CUDA-event times on the card
(:mod:`..utils.timing`).

Usage: python -m sparsifyme_tpu_torch.bench.torch_compare
           [--model resnet18] [--density 0.1] [--limit N] [--batch 32]
           [--cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List

import numpy as np
import torch

from .. import _build
from ..ops.gemm import _strict_cuda_matmul
from ..utils.timing import time_kernel


def time_torch_pair(m: int, n: int, k: int, b: int, density: float,
                    reps: int = 3, iters: int = 4,
                    device=None) -> Dict[str, float]:
    """Dense ``torch.matmul`` against ``to_sparse`` + ``torch.sparse.mm``
    per batch on ``device`` (``None``: the GPU): ``dense_ms``,
    ``sparse_ms``, ``convert_ms`` (medians over ``reps`` runs of ``iters``
    calls) and ``rel_err`` (Frobenius norm of the difference over the
    dense product's)."""
    dev = _build.resolve_device(device)
    if dev.type == "cuda":
        _strict_cuda_matmul()  # full-f32 cuBLAS, no TF32
    gen = torch.Generator(device=dev).manual_seed(0)
    a = torch.randn((m, k), generator=gen, device=dev)
    a = a * (torch.rand((m, k), generator=gen, device=dev) < density)
    bmat = torch.randn((b, k, n), generator=gen, device=dev)

    def sparse_mm(a_sp, y):
        return torch.stack([torch.sparse.mm(a_sp, y[i])
                            for i in range(y.shape[0])])

    a_sp = a.to_sparse()
    out_d = torch.matmul(a, bmat)
    out_s = sparse_mm(a_sp, bmat)
    err = float(torch.linalg.norm(out_s - out_d) / torch.linalg.norm(out_d))
    del out_d, out_s
    return {
        "dense_ms": time_kernel(torch.matmul, (a, bmat), iters=iters,
                                reps=reps).ms,
        "sparse_ms": time_kernel(sparse_mm, (a_sp, bmat), iters=iters,
                                 reps=reps).ms,
        "convert_ms": time_kernel(lambda x: x.to_sparse(), (a,),
                                  iters=iters, reps=reps).ms,
        "rel_err": err,
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--model", default="resnet18")
    p.add_argument("--density", type=float, default=0.1,
                   help="fraction of nonzeros (the reference used 0.1)")
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--batch", type=int, default=32,
                   help="the datasets' b=32")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (surface check; timings are not "
                        "device measurements)")
    args = p.parse_args(argv)

    from ..models.resnet_shapes import resnet_conv_shapes

    shapes = sorted(set(resnet_conv_shapes(args.model)))
    if args.limit:
        shapes = shapes[:args.limit]

    rows: List[Dict] = []
    for s in shapes:
        r = time_torch_pair(s.m, s.n, s.k, args.batch, args.density,
                            device="cpu" if args.cpu else None)
        r.update(m=s.m, n=s.n, k=s.k, b=args.batch)
        rows.append(r)
        print(f"m={s.m} n={s.n} k={s.k}: dense {r['dense_ms']:.4f} ms "
              f"sparse {r['sparse_ms']:.4f} ms (+convert "
              f"{r['convert_ms']:.4f} ms) err {r['rel_err']:.1e}",
              file=sys.stderr, flush=True)

    summary = {
        "points": len(rows),
        "density": args.density,
        "dense_ms_median": float(np.median([r["dense_ms"] for r in rows])),
        "sparse_plus_convert_ms_median": float(
            np.median([r["sparse_ms"] + r["convert_ms"] for r in rows])),
        "rel_err_max": max(r["rel_err"] for r in rows),
    }
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
