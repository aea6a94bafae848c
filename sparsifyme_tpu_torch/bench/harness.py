"""Benchmark harness: sparse-vs-dense sweep over layer-shape datasets.

Counterpart of ``sparsifyme_tpu.bench.harness`` on the GPU. For each
unique ``(m, n, k, b)`` layer it times the dense baseline
(:func:`~..ops.gemm.batched_gemm`), the 2:4 pipeline prune -> compress ->
matmul (kernels K1, K2, K3) and Blocked-ELL at 50% block sparsity (K4),
and reports speedups as paired ratios against the dense baseline.

It follows the JAX harness's untuned path: the dense baseline races
``fold`` True/False; the fused prune+compress (the K2 route that
:func:`~..ops.sparse24.prune_compress_24` takes) is timed on the dense
operand as ``fused_ms``; the 2:4 SpMM races ``transpose_out`` False/True;
Blocked-ELL is built with ``block_size=128``, ``block_k`` 32/64/128 by k
and the ``fold_first`` heuristic, and races the gather kernel (K4) in both
output layouts plus, on layers with k < 512, the expand kernel (K5) in
both layouts, so ``ell_ms`` is the fastest of four candidates there. The
per-shape tuning table is not read (the TPU's winners mean nothing on an
H100, and the port has no table yet).
"""

from __future__ import annotations

import csv
import dataclasses
import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from .. import _build
from ..models.resnet_shapes import resnet_conv_shapes
from ..ops.ell import ell_from_dense, ell_values_kmajor, spmm_ell
from ..ops.gemm import batched_gemm
from ..ops.kernels.ell_kernel import (ell_expand_spmm_cuda,
                                      ell_expand_spmm_plain)
from ..ops.prune import prune_nm
from ..ops.sparse24 import compress_24, prune_compress_24, spmm_24
from ..utils.shapes import LayerShape
from ..utils.timing import time_kernel, time_kernel_pair
from .roofline import (compress_sol_ms, dense_sol_ms, ell_sol_ms,
                       fused_sol_ms, prune_sol_ms, spmm24_sol_ms)


@dataclasses.dataclass
class ShapeResult:
    layer: int
    m: int
    n: int
    k: int
    b: int
    gemm_ms: float = math.nan
    prune_ms: float = math.nan
    compress_ms: float = math.nan
    fused_ms: float = math.nan        # fused prune+compress (dense in)
    spmm24_ms: float = math.nan       # 2:4 matmul phase
    ell_ms: float = math.nan          # blocked-ELL SpMM @50% block sparsity
    gemm_tflops: float = math.nan
    spmm24_tflops: float = math.nan   # effective (dense-equivalent) rate
    ell_tflops: float = math.nan
    spmm24_speedup: float = math.nan
    ell_speedup: float = math.nan
    nnz_per_s: float = math.nan       # 2:4 kernel nonzeros/second
    gemm24_pair_ms: float = math.nan  # dense ms from the 2:4 pair
    gemmell_pair_ms: float = math.nan  # dense ms from the ELL pair
    pair_spread24: float = math.nan   # max/min per-pair ratio (2:4)
    pair_spreadell: float = math.nan  # max/min per-pair ratio (ELL)
    sol24_ms: float = math.nan        # 2:4 bound on this card
    sol_speedup: float = math.nan     # dense bound / 2:4 bound
    spmm24_frac_sol: float = math.nan
    ell_sol_ms: float = math.nan
    ell_frac_sol: float = math.nan
    fused_sol_ms: float = math.nan
    fused_frac_sol: float = math.nan
    prune_sol_ms: float = math.nan
    compress_sol_ms: float = math.nan

    def row(self) -> List:
        return [getattr(self, f.name) for f in dataclasses.fields(self)]


CSV_COLUMNS = [f.name for f in dataclasses.fields(ShapeResult)]


def _round_up(a: int, b: int) -> int:
    return -(-a // b) * b


def build_ell_operand(a: torch.Tensor, *, block_size: int, block_k: int,
                      fold_first: bool):
    """The benchmark's Blocked-ELL operand at 50% block sparsity from a
    dense batch ``a [b, m, k]``; returns ``(ell, kp)``.

    ``fold_first=True`` stacks the batch into one tall ``[b*m, k]`` matrix
    before block selection (block-rows may span samples), which removes
    the per-sample m-padding; ``False`` keeps a batch of per-sample
    matrices. k pads to an even number of ``block_k`` blocks.
    """
    b_, m, k = a.shape
    bs, bkb = block_size, block_k
    kp = _round_up(k, 2 * bkb)
    ell_blocks = max(1, (kp // bkb) // 2)
    if fold_first:
        mp = _round_up(b_ * m, bs)
        ap = F.pad(a.reshape(b_ * m, k), (0, kp - k, 0, mp - b_ * m))
    else:
        mp = _round_up(m, bs)
        ap = F.pad(a, (0, kp - k, 0, mp - m))
    return ell_from_dense(ap, bs, ell_blocks, bkb), kp


def _race(cands, iters: int, reps: int) -> int:
    """Index of the fastest ``(fn, operands)`` candidate."""
    times = [time_kernel(fn, ops, iters=iters, reps=reps).ms
             for fn, ops in cands]
    return int(np.argmin(times))


def bench_shape(
    shape: LayerShape,
    *,
    dtype: torch.dtype = torch.bfloat16,
    kernels: Sequence[str] = ("gemm", "prune", "spmm24", "ell"),
    iters: int = 16,
    reps: int = 3,
    seed: int = 0,
    device=None,
    verbose: bool = False,
) -> Dict[str, float]:
    """Time the requested kernels for one ``(m, n, k, b)`` problem: a
    batch of A ``(b, m, k)`` against one shared B ``(k, n)``, made on the
    device from ``seed``."""
    dev = _build.resolve_device(device)
    m, n, k, b = shape
    gen = torch.Generator(device=dev).manual_seed(seed)
    a = torch.randn((b, m, k), generator=gen, device=dev).to(dtype)
    bm = torch.randn((k, n), generator=gen, device=dev).to(dtype)
    out: Dict[str, float] = {}
    flops = 2.0 * m * n * k * b

    def mark(what: str) -> None:
        if verbose:
            print(f"    .. {what}", flush=True)

    dense_fn = None
    if "gemm" in kernels:
        mark("gemm")
        cands = [(lambda x, y, _f=f: batched_gemm(x, y, out_dtype=dtype,
                                                  fold=_f), (a, bm))
                 for f in (True, False)]
        times = [time_kernel(fn, ops, iters=iters, reps=reps).ms
                 for fn, ops in cands]
        dense_fn = cands[int(np.argmin(times))][0]
        out["gemm_ms"] = min(times)
        out["gemm_tflops"] = flops / (min(times) * 1e9)

    def paired(fn, operands):
        """(sparse_ms, paired_dense_ms, speedup, spread)."""
        if dense_fn is None:
            t = time_kernel(fn, operands, iters=iters, reps=reps)
            return t.ms, math.nan, math.nan, math.nan
        p = time_kernel_pair(dense_fn, (a, bm), fn, operands, iters=iters,
                             reps=reps)
        return p.b.ms, p.a.ms, p.ratio, p.ratio_spread

    pruned = None
    if "prune" in kernels or "spmm24" in kernels:
        mark("prune")
        pruned = prune_nm(a, 2, 4)[0]
        # Times the full op (pruned values and mask), on pruned input:
        # pruning it again is the same work.
        out["prune_ms"] = time_kernel(lambda x: prune_nm(x, 2, 4),
                                      (pruned,), iters=iters, reps=reps).ms

    if "spmm24" in kernels:
        mark("compress")
        out["compress_ms"] = time_kernel(compress_24, (pruned,),
                                         iters=max(4, iters // 2),
                                         reps=reps).ms
        mark("fused")
        out["fused_ms"] = time_kernel(prune_compress_24, (a,),
                                      iters=max(4, iters // 2),
                                      reps=reps).ms
        s = compress_24(pruned)
        mark("spmm24")
        cands = [(lambda ss, y, _t=tr: spmm_24(ss, y, out_dtype=dtype,
                                               transpose_out=_t), (s, bm))
                 for tr in (False, True)]
        fn24, ops24 = cands[_race(cands, iters, reps)]
        ms24, gp24, sp24, spread24 = paired(fn24, ops24)
        out.update(spmm24_ms=ms24, gemm24_pair_ms=gp24,
                   pair_spread24=spread24)
        if sp24 == sp24:
            out["spmm24_speedup"] = sp24
        out["spmm24_tflops"] = flops / (ms24 * 1e9)
        out["nnz_per_s"] = (b * m * (k // 2)) / (ms24 * 1e-3)

    if "ell" in kernels:
        mark("ell")
        bkb = 32 if k < 512 else (64 if k < 1536 else 128)
        ff = m % 128 != 0 and (m * b) % 128 == 0
        e, kp = build_ell_operand(a, block_size=128, block_k=bkb,
                                  fold_first=ff)
        bp = F.pad(bm, (0, 0, 0, kp - k))
        cands = [(lambda ee, y, _t=tr: spmm_ell(ee, y, out_dtype=dtype,
                                                transpose_out=_t), (e, bp))
                 for tr in (False, True)]
        if k < 512:
            # The expand formulation, as the JAX harness races it on small
            # k; the k-major values are built once, outside the timing.
            vkm = ell_values_kmajor(e)
            cols = e.col_indices.reshape(-1, e.col_indices.shape[-1])
            expand = (ell_expand_spmm_cuda if _build.use_kernel(vkm)
                      else ell_expand_spmm_plain)
            cands += [(lambda v, y, c, _t=tr: expand(
                v, c, y, block_size=128, block_k=bkb, out_dtype=dtype,
                transpose_out=_t), (vkm, bp, cols)) for tr in (False, True)]
        fne, opse = cands[_race(cands, iters, reps)]
        mse, gpe, spe, spreade = paired(fne, opse)
        out.update(ell_ms=mse, gemmell_pair_ms=gpe, pair_spreadell=spreade)
        if spe == spe:
            out["ell_speedup"] = spe
        out["ell_tflops"] = flops / (mse * 1e9)

    sol_dense = dense_sol_ms(m, n, k, b)
    sol24 = spmm24_sol_ms(m, n, k, b)
    sol_ell = ell_sol_ms(m, n, k, b)
    sol_fused = fused_sol_ms(m, k, b)
    out.update(sol24_ms=sol24, sol_speedup=sol_dense / sol24,
               ell_sol_ms=sol_ell, prune_sol_ms=prune_sol_ms(m, k, b),
               compress_sol_ms=compress_sol_ms(m, k, b),
               fused_sol_ms=sol_fused)
    if out.get("fused_ms", 0) > 0:
        out["fused_frac_sol"] = sol_fused / out["fused_ms"]
    if out.get("spmm24_ms", 0) > 0:
        out["spmm24_frac_sol"] = sol24 / out["spmm24_ms"]
    if out.get("ell_ms", 0) > 0:
        out["ell_frac_sol"] = sol_ell / out["ell_ms"]
    return out


def sweep(
    shapes: Sequence[LayerShape],
    *,
    dtype: torch.dtype = torch.bfloat16,
    kernels: Sequence[str] = ("gemm", "prune", "spmm24", "ell"),
    iters: int = 10,
    reps: int = 3,
    device=None,
    verbose: bool = True,
) -> List[ShapeResult]:
    """Sweep shapes (deduplicated), returning one result per input layer."""
    cache: Dict[LayerShape, Dict[str, float]] = {}
    results = []
    for i, sh in enumerate(shapes):
        if sh not in cache:
            cache[sh] = bench_shape(sh, dtype=dtype, kernels=kernels,
                                    iters=iters, reps=reps, device=device,
                                    verbose=verbose)
            if verbose:
                print(f"[{len(cache):3d} uniq] m={sh.m:6d} n={sh.n:5d} "
                      f"k={sh.k:5d} b={sh.b}  " + " ".join(
                          f"{kk}={vv:.4f}" for kk, vv in cache[sh].items()
                          if kk.endswith("_ms")), flush=True)
        results.append(ShapeResult(layer=i, m=sh.m, n=sh.n, k=sh.k, b=sh.b,
                                   **cache[sh]))
    return results


def write_csv(path: str, results: Sequence[ShapeResult]) -> None:
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(CSV_COLUMNS)
        for r in results:
            w.writerow(r.row())


def write_compare_csv(path: str, results: Sequence[ShapeResult]) -> None:
    """The reference's compare.csv schema (layer,m,n,k,b,gemm,prune,spmm)
    plus a trailing spmm24 column; ``spmm`` is the Blocked-ELL time, the
    reference's own sparse path."""
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["layer", "m", "n", "k", "b", "gemm", "prune", "spmm",
                    "spmm24"])
        for r in results:
            w.writerow([r.layer, r.m, r.n, r.k, r.b, r.gemm_ms, r.prune_ms,
                        r.ell_ms, r.spmm24_ms])


def geomean(xs: Sequence[float]) -> float:
    xs = [x for x in xs if x == x and x > 0]
    if not xs:
        return float("nan")
    return float(np.exp(np.mean(np.log(xs))))


def _best(*xs: float) -> float:
    return max([x for x in xs if x == x] or [float("nan")])


def summarize(results: Sequence[ShapeResult]) -> Dict[str, float]:
    spreads = {(r.m, r.n, r.k, r.b): _best(r.pair_spread24, r.pair_spreadell)
               for r in results}
    return {
        "layers": len(results),
        "gemm_tflops_geomean": geomean([r.gemm_tflops for r in results]),
        "spmm24_tflops_geomean": geomean([r.spmm24_tflops for r in results]),
        "ell_tflops_geomean": geomean([r.ell_tflops for r in results]),
        "spmm24_speedup_geomean": geomean(
            [r.spmm24_speedup for r in results]),
        "ell_speedup_geomean": geomean([r.ell_speedup for r in results]),
        # Best sparse format per layer (2:4 or blocked-ELL@50%).
        "best_sparse_speedup_geomean": geomean(
            [_best(r.spmm24_speedup, r.ell_speedup) for r in results]),
        "nnz_per_s_geomean": geomean([r.nnz_per_s for r in results]),
        "prune_ms_geomean": geomean([r.prune_ms for r in results]),
        "compress_ms_geomean": geomean([r.compress_ms for r in results]),
        "fused_ms_geomean": geomean([r.fused_ms for r in results]),
        "sol_speedup_geomean": geomean([r.sol_speedup for r in results]),
        "spmm24_frac_sol_geomean": geomean(
            [r.spmm24_frac_sol for r in results]),
        "ell_frac_sol_geomean": geomean([r.ell_frac_sol for r in results]),
        "fused_frac_sol_geomean": geomean(
            [r.fused_frac_sol for r in results]),
        "pair_spread_max": _best(*spreads.values()),
        "pair_spread_worst": [
            f"{m}x{n}x{k}x{b}:{v:.2f}" for (m, n, k, b), v in sorted(
                spreads.items(), key=lambda kv: -(kv[1] if kv[1] == kv[1]
                                                  else 0.0))[:3]
            if v == v],
    }


def run_model_sweep(
    model: str = "resnet50",
    *,
    dtype: torch.dtype = torch.bfloat16,
    kernels: Sequence[str] = ("gemm", "prune", "spmm24", "ell"),
    iters: int = 10,
    reps: int = 3,
    csv_path: Optional[str] = None,
    compare_csv_path: Optional[str] = None,
    max_layers: Optional[int] = None,
    device=None,
    verbose: bool = True,
):
    shapes = resnet_conv_shapes(model)
    if max_layers:
        shapes = shapes[:max_layers]
    results = sweep(shapes, dtype=dtype, kernels=kernels, iters=iters,
                    reps=reps, device=device, verbose=verbose)
    if csv_path:
        write_csv(csv_path, results)
    if compare_csv_path:
        write_compare_csv(compare_csv_path, results)
    return results, summarize(results)


def headline(model: str, summary: Dict[str, float],
             where: str = "1 GPU (H100)") -> Dict:
    """The one-line JSON record of ``bench.py``; ``where`` names what the
    sweep ran on."""
    value = summary.get("best_sparse_speedup_geomean", float("nan"))
    if value != value:  # single-kernel runs (e.g. --kernels gemm)
        value = summary.get("gemm_tflops_geomean", float("nan"))

    def r(x):
        return round(x, 4) if (x is not None and x == x) else None

    return {
        "metric": (f"{model} best-sparse SpMM (blocked-ELL@50% / 2:4) "
                   f"speedup vs dense GEMM (geomean over layers, bf16, "
                   f"{where}, paired timing)"),
        "value": r(value),
        "unit": "x",
        "vs_baseline": r(value / 1.5),
        **{key: r(summary.get(key)) for key in (
            "spmm24_speedup_geomean", "ell_speedup_geomean",
            "best_sparse_speedup_geomean", "spmm24_tflops_geomean",
            "ell_tflops_geomean", "gemm_tflops_geomean",
            "sol_speedup_geomean", "spmm24_frac_sol_geomean",
            "ell_frac_sol_geomean", "fused_frac_sol_geomean",
            "pair_spread_max")},
        "pair_spread_worst": summary.get("pair_spread_worst"),
    }
