"""Benchmark harness: sparse-vs-dense sweep over layer-shape datasets.

Counterpart of ``sparsifyme_tpu.bench.harness`` on the GPU. For each
unique ``(m, n, k, b)`` layer it times the dense baseline
(:func:`~..ops.gemm.batched_gemm`), the 2:4 pipeline prune -> compress ->
matmul (kernels K1, K2, K3) and Blocked-ELL at 50% block sparsity (K4, K5),
and reports speedups as paired ratios against the dense baseline.

A shape with an entry in the tuning table (:mod:`.tuning`, written on the
card by :mod:`.tune`) takes the tuned path: the gemm's ``fold`` is pinned,
the fused prune+compress runs the tuned fold, the 2:4 SpMM races its tuned
winner against the default (:data:`DEFAULT_SPMM24`: K3's ``wgmma_sp``
route where the shape qualifies, else ``pick_tile``'s ``mma_sp`` tile, row
major C) unless the winner is that call, and Blocked-ELL its tuned winner
against the gather kernel with ``ell_plan``'s pick in the other output
layout: each winner plus one alternative, the best-of-2 guard of the JAX
harness against a winner that was noise.

A shape without an entry takes the untuned race: the dense baseline races
``fold`` True/False; the fused route (K2 on the dense operand) is timed as
``fused_ms``; the 2:4 SpMM races K3's ``wgmma_sp`` route (where the shape
qualifies: bf16, ``b * m`` a multiple of 128, n of 64) against its
``mma_sp`` tile with ``transpose_out`` False/True; Blocked-ELL
is built with ``block_size=128``, ``block_k`` 32/64/128 by k and the
``fold_first`` heuristic, and races the gather kernel (K4) in both output
layouts plus, on layers with k < 512, the expand kernel (K5) in both.

Where a 2:4 candidate takes the ``wgmma_sp`` route, its operand is packed
once after compress (``ops.sparse24.pack_wg``, outside the SpMM's timed
calls, as the reference's cusparseLt compresses apart from its matmul) and
the pack is timed as its own phase, ``pack_ms``; each shape's winning
design is ``spmm24_design``. Both go on the per-shape progress line and in
the CSV, not in the JSON line (whose keys are the JAX harness's).

Every time is held to its bound (:mod:`.roofline`): a reading under 0.85x
the bound is re-measured once (:func:`_guarded`), and a paired reading with
a side under its bound, or a spread of the per-pair ratios above 1.5, up to
twice (:func:`_paired`); each re-measure is printed.
"""

from __future__ import annotations

import csv
import dataclasses
import math
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from .. import _build
from ..models.resnet_shapes import resnet_conv_shapes
from ..containers import BlockedEll, Sparse24
from ..ops.ell import ell_from_dense, ell_values_kmajor, spmm_ell
from ..ops.gemm import batched_gemm
from ..ops.kernels.ell_kernel import (ell_expand_spmm_cuda,
                                      ell_expand_spmm_plain)
from ..ops.kernels.spmm24_kernel import (spmm24_cuda, spmm24_plain,
                                         spmm24_wg_cuda, spmm24_wg_plain,
                                         wg_shape)
from ..ops.prune import prune_nm
from ..ops.sparse24 import (compress_24, pack_codes_fp, pack_wg,
                            prune_compress_24, spmm24_design, spmm_24)
from ..utils.shapes import LayerShape
from ..utils.timing import Timing, time_kernel, time_kernel_pair
from . import tuning
from .roofline import (compress_sol_ms, dense_sol_ms, ell_sol_ms,
                       fused_sol_ms, pack_wg_sol_ms, prune_sol_ms,
                       spmm24_sol_ms)

SUB_BOUND = 0.85  # a reading under this share of its bound is re-measured
MAX_SPREAD = 1.5  # a pair whose per-pair ratios spread more is re-measured
# the untuned 2:4 configuration that a tuned winner races: design None is
# K3's wgmma_sp route wherever the call qualifies, else its mma_sp tile
DEFAULT_SPMM24 = {"design": None, "tile": None, "transpose_out": False,
                  "packed": False, "fold": 1}


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
    sol24_ms: float = math.nan        # 2:4 bound, unpacked codes
    sol_speedup: float = math.nan     # dense bound / 2:4 bound
    spmm24_frac_sol: float = math.nan
    ell_sol_ms: float = math.nan
    ell_frac_sol: float = math.nan
    fused_sol_ms: float = math.nan
    fused_frac_sol: float = math.nan
    prune_sol_ms: float = math.nan
    compress_sol_ms: float = math.nan
    pack_ms: float = math.nan         # K3's wgmma_sp operand from the planes
    pack_sol_ms: float = math.nan
    spmm24_design: str = ""           # K3's tile in the 2:4 race's winner

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


def heuristic_block_k(k: int) -> int:
    """The untuned ELL block edge: 32, 64 or 128 by k."""
    return 32 if k < 512 else (64 if k < 1536 else 128)


def can_fold_first(m: int, b: int) -> bool:
    """Folding the batch first removes m-padding: m alone is not a
    multiple of the 128-row block, ``m * b`` is."""
    return m % 128 != 0 and (m * b) % 128 == 0


def spmm24_call(cand: Dict, s: Sparse24, s_fold: Optional[Sparse24],
                b: torch.Tensor, dtype: torch.dtype,
                s_wg: Optional[Sparse24] = None):
    """``(fn, operands)`` of a 2:4 candidate (a ``spmm24`` entry of the
    tuning table): fold=2 planes ``s_fold`` through the fold route, packed
    codes packed once here (outside the timed calls, as the JAX harness
    packs them) and handed to K3, ``spmm_24`` with the forced tile, layout
    and ``design`` (``s_wg``, the planes with their ``wgmma_sp`` operand,
    where the design is not ``mma_sp`` and ``s_wg`` is given), or, for a
    ``wgmma_sp`` candidate with a forced plan (``block_n``, ``splits``),
    K3's ``wgmma_sp`` wrapper on ``s_wg``'s operand. The packed call
    returns K3's ``[M, n]`` (or C^T), the others what ``spmm_24``
    returns."""
    tile = cand.get("tile")
    design = cand.get("design")
    if int(cand.get("fold", 1) or 1) > 1:
        return (lambda ss, y: spmm_24(ss, y, out_dtype=dtype, tile=tile,
                                      design=design), (s_fold, b))
    tout = bool(cand.get("transpose_out", False))
    if cand.get("packed"):
        kern = spmm24_cuda if _build.use_kernel(s.values0) else spmm24_plain
        k = s.shape[-1]
        return (lambda v0, v1, cp, y: kern(
            v0, v1, cp, y, k_logical=k, out_dtype=dtype, transpose_out=tout,
            packed_codes=True, tile=tile),
            (s.values0, s.values1, pack_codes_fp(s.codes), b))
    if design == "wgmma_sp" and (cand.get("block_n") or cand.get("splits")):
        kern = (spmm24_wg_cuda if _build.use_kernel(s_wg.values0)
                else spmm24_wg_plain)
        kw = dict(m=s_wg.values0.shape[-1], k_logical=s_wg.shape[-1],
                  out_dtype=dtype, block_n=cand.get("block_n"),
                  splits=cand.get("splits"))
        return (lambda pk, y: kern(pk, y, **kw), (s_wg.wg.packed, b))
    src = s_wg if (design != "mma_sp" and s_wg is not None) else s
    return (lambda ss, y: spmm_24(ss, y, out_dtype=dtype, transpose_out=tout,
                                  tile=tile, design=design), (src, b))


def spmm24_key(cand: Dict, s_wg: Optional[Sparse24], b: torch.Tensor,
               dtype: torch.dtype) -> tuple:
    """What a 2:4 candidate runs: its K3 tile as ``spmm_24`` resolves it
    (:func:`~..ops.sparse24.spmm24_design`, on ``s_wg`` where there is
    one) and its knobs, so that the default and a tuned winner that make
    the same call are raced once."""
    fold = int(cand.get("fold", 1) or 1)
    design = cand.get("design")
    if fold > 1 or s_wg is None:
        design = "mma_sp" if design is None else design
    else:
        design = spmm24_design(
            s_wg, b, out_dtype=dtype,
            transpose_out=bool(cand.get("transpose_out", False)),
            packed_codes=bool(cand.get("packed")), tile=cand.get("tile"),
            design=design)
    return (design, cand.get("tile"), bool(cand.get("transpose_out")),
            bool(cand.get("packed")), fold, cand.get("block_n"),
            cand.get("splits"))


def ell_call(cand: Dict, e: BlockedEll, bp: torch.Tensor,
             dtype: torch.dtype):
    """``(fn, operands)`` of an ELL candidate (an ``ell`` entry of the
    tuning table) on the operand ``e`` it names: ``spmm_ell`` with the
    forced plan (K4), or K5 on k-major values built once here, outside the
    timed calls."""
    tout = bool(cand.get("transpose_out", False))
    if cand.get("formulation", "gather") == "gather":
        bn, splits = cand.get("block_n"), cand.get("splits")
        return (lambda ee, y: spmm_ell(ee, y, out_dtype=dtype,
                                       transpose_out=tout, block_n=bn,
                                       splits=splits), (e, bp))
    vkm = ell_values_kmajor(e)
    cols = e.col_indices.reshape(-1, e.col_indices.shape[-1])
    expand = (ell_expand_spmm_cuda if _build.use_kernel(vkm)
              else ell_expand_spmm_plain)
    return (lambda v, y, c: expand(
        v, c, y, block_size=e.block_size, block_k=e.block_k, out_dtype=dtype,
        transpose_out=tout), (vkm, bp, cols))


def _guarded(fn, operands, floor_ms: float, *, iters: int, reps: int,
             what: str = "") -> Timing:
    """``time_kernel`` with one re-measure (``reps`` at least 3) of a
    reading under :data:`SUB_BOUND` of the bound ``floor_ms``, which no
    card can reach: with operands partly in the 50 MB L2 a call may read
    less than the bound counts. The re-measure is printed and replaces the
    reading."""
    t = time_kernel(fn, operands, iters=iters, reps=reps)
    if 0 < t.ms < SUB_BOUND * floor_ms:
        first = t.ms
        t = time_kernel(fn, operands, iters=iters, reps=max(reps, 3))
        print(f"      {what}: {first:.4f} ms < {SUB_BOUND} x bound "
              f"{floor_ms:.4f} ms, re-measured: {t.ms:.4f} ms", flush=True)
    return t


def _race(cands, floor_ms, iters: int, reps: int, what: str) -> int:
    """Index of the fastest ``(fn, operands)`` candidate, each guarded by
    ``floor_ms`` (a number, or one bound per candidate)."""
    floors = (floor_ms if isinstance(floor_ms, (list, tuple))
              else [floor_ms] * len(cands))
    times = [_guarded(fn, ops, floor, iters=iters, reps=reps,
                      what=f"{what} candidate {i}").ms
             for i, ((fn, ops), floor) in enumerate(zip(cands, floors))]
    return int(np.argmin(times))


def _paired(dense, fn, operands, floor_ms: float, dense_floor_ms: float, *,
            iters: int, reps: int, what: str = ""):
    """``(sparse_ms, paired_dense_ms, speedup, spread)`` of ``fn`` against
    the dense baseline ``dense = (fn, operands)`` (unpaired without one).
    A pair with a side under :data:`SUB_BOUND` of its bound, or a spread of
    the per-pair ratios above :data:`MAX_SPREAD` (the card's clock moved
    between reps), is re-measured up to twice with ``reps`` at least 3;
    each re-measure is printed, and the last pair is published."""
    if dense is None:
        t = _guarded(fn, operands, floor_ms, iters=iters, reps=reps,
                     what=what)
        return t.ms, math.nan, math.nan, math.nan
    p = time_kernel_pair(dense[0], dense[1], fn, operands, iters=iters,
                         reps=reps)
    for _ in range(2):
        sub = (0 < p.b.ms < SUB_BOUND * floor_ms
               or 0 < p.a.ms < SUB_BOUND * dense_floor_ms)
        spread = p.ratio_spread == p.ratio_spread and \
            p.ratio_spread > MAX_SPREAD
        if not (sub or spread):
            break
        print(f"      {what} pair: {p.b.ms:.4f} ms vs dense {p.a.ms:.4f} "
              f"ms (bounds {floor_ms:.4f} / {dense_floor_ms:.4f}), spread "
              f"{p.ratio_spread:.3f}: re-measured", flush=True)
        p = time_kernel_pair(dense[0], dense[1], fn, operands, iters=iters,
                             reps=max(reps, 3))
    return p.b.ms, p.a.ms, p.ratio, p.ratio_spread


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
    device from ``seed``. The shape's tuning-table entry, where there is
    one, picks the configurations raced (module docstring)."""
    dev = _build.resolve_device(device)
    m, n, k, b = shape
    gen = torch.Generator(device=dev).manual_seed(seed)
    a = torch.randn((b, m, k), generator=gen, device=dev).to(dtype)
    bm = torch.randn((k, n), generator=gen, device=dev).to(dtype)
    out: Dict[str, float] = {}
    flops = 2.0 * m * n * k * b
    tuned = tuning.lookup(m, n, k, b) or {}
    e24 = tuned.get("spmm24") or {}
    sol_dense = dense_sol_ms(m, n, k, b)
    # the published 2:4 bound is the shape's (unpacked codes), so that
    # tuned and untuned sweeps are held to the same yardstick; a packed
    # candidate's own, lower bound only guards its readings
    sol24 = spmm24_sol_ms(m, n, k, b)
    sol_ell = ell_sol_ms(m, n, k, b)
    sol_fused = fused_sol_ms(m, k, b)
    sol_prune = prune_sol_ms(m, k, b)
    sol_compress = compress_sol_ms(m, k, b)
    sol_pack = pack_wg_sol_ms(m, k, b)
    tag = f"{m}x{n}x{k}x{b}"

    def mark(what: str) -> None:
        if verbose:
            print(f"    .. {what}", flush=True)

    if tuned:
        mark(f"tuned entry ({tuned.get('card', 'no card')})")
    dense = None
    if "gemm" in kernels:
        mark("gemm")
        folds = ((bool(tuned["gemm"]["fold"]),) if "gemm" in tuned
                 else (True, False))
        cands = [(lambda x, y, _f=f: batched_gemm(x, y, out_dtype=dtype,
                                                  fold=_f), (a, bm))
                 for f in folds]
        times = [_guarded(fn, ops, sol_dense, iters=iters, reps=reps,
                          what=f"{tag} gemm fold={f}").ms
                 for f, (fn, ops) in zip(folds, cands)]
        dense = cands[int(np.argmin(times))]
        out["gemm_ms"] = min(times)
        out["gemm_tflops"] = flops / (min(times) * 1e9)

    pruned = None
    if "prune" in kernels or "spmm24" in kernels:
        mark("prune")
        pruned = prune_nm(a, 2, 4)[0]
        # Times the full op (pruned values and mask), on pruned input:
        # pruning it again is the same work.
        out["prune_ms"] = _guarded(lambda x: prune_nm(x, 2, 4), (pruned,),
                                   sol_prune, iters=iters, reps=reps,
                                   what=f"{tag} prune").ms

    if "spmm24" in kernels:
        mark("compress")
        out["compress_ms"] = _guarded(compress_24, (pruned,), sol_compress,
                                      iters=max(4, iters // 2), reps=reps,
                                      what=f"{tag} compress").ms
        fold = int((tuned.get("fused") or {}).get("fold", 1) or 1)
        mark(f"fused fold={fold}")
        out["fused_ms"] = _guarded(
            lambda x: prune_compress_24(x, fold=fold), (a,), sol_fused,
            iters=max(4, iters // 2), reps=reps, what=f"{tag} fused").ms
        s = compress_24(pruned)
        # the planes with K3's wgmma_sp operand, packed once where the shape
        # can take that route: the candidates resolve their tile on it
        s_wg = pack_wg(s) if wg_shape(b * m, n, dtype) else None
        if e24:
            # the tuned winner, and the default as its best-of-2 guard
            # unless the two make the same call
            variants = [e24]
            if spmm24_key(e24, s_wg, bm, dtype) != spmm24_key(
                    DEFAULT_SPMM24, s_wg, bm, dtype):
                variants.append(DEFAULT_SPMM24)
        else:
            variants = ([dict(DEFAULT_SPMM24, design="wgmma_sp")]
                        if s_wg is not None else [])
            variants += [dict(DEFAULT_SPMM24, design="mma_sp",
                              transpose_out=tr) for tr in (False, True)]
        keys = [spmm24_key(v, s_wg, bm, dtype) for v in variants]
        if any(key[0] == "wgmma_sp" for key in keys):
            mark("pack_wg")
            out["pack_ms"] = _guarded(
                pack_wg, (s,), sol_pack, iters=max(4, iters // 2),
                reps=reps, what=f"{tag} pack_wg").ms
        s_fold = (prune_compress_24(pruned, fold=2)
                  if any(int(v.get("fold", 1) or 1) > 1 for v in variants)
                  else None)
        cands = [spmm24_call(v, s, s_fold, bm, dtype, s_wg)
                 for v in variants]
        # the wgmma_sp operand is 1.125 B a logical element, as packed codes
        floors = [spmm24_sol_ms(m, n, k, b, packed_codes=bool(
            v.get("packed")) or key[0] == "wgmma_sp")
            for v, key in zip(variants, keys)]
        win = _race(cands, floors, iters, reps, f"{tag} spmm24") \
            if len(cands) > 1 else 0
        out["spmm24_design"] = keys[win][0]
        mark(f"spmm24 {'tuned ' if e24 else ''}candidate {win} of "
             f"{len(cands)} won: {variants[win]} ({keys[win][0]})")
        ms24, gp24, sp24, spread24 = _paired(
            dense, *cands[win], floors[win], sol_dense, iters=iters,
            reps=reps, what=f"{tag} spmm24")
        out.update(spmm24_ms=ms24, gemm24_pair_ms=gp24,
                   pair_spread24=spread24)
        if sp24 == sp24:
            out["spmm24_speedup"] = sp24
        out["spmm24_tflops"] = flops / (ms24 * 1e9)
        out["nnz_per_s"] = (b * m * (k // 2)) / (ms24 * 1e-3)

    if "ell" in kernels:
        mark("ell")
        te = tuned.get("ell") or {}
        bkb = te.get("block_k") or heuristic_block_k(k)
        ff = (bool(te.get("fold_first")) if te
              else can_fold_first(m, b))
        e, kp = build_ell_operand(a, block_size=te.get("block_size", 128),
                                  block_k=bkb, fold_first=ff)
        bp = F.pad(bm, (0, 0, 0, kp - k))
        if te:
            # the tuned winner, and the gather kernel under ell_plan's pick
            # in the other layout as its best-of-2 guard
            forms = [te, {"formulation": "gather",
                          "transpose_out": not te.get("transpose_out",
                                                      False)}]
        else:
            forms = [{"formulation": "gather", "transpose_out": tr}
                     for tr in (False, True)]
            if k < 512:
                # The expand formulation, as the JAX harness races it on
                # small k.
                forms += [{"formulation": "expand", "transpose_out": tr}
                          for tr in (False, True)]
        cands = [ell_call(f, e, bp, dtype) for f in forms]
        win = _race(cands, sol_ell, iters, reps, f"{tag} ell")
        mark(f"ell {'tuned ' if te else ''}candidate {win} of "
             f"{len(cands)} won: {forms[win]}")
        mse, gpe, spe, spreade = _paired(
            dense, *cands[win], sol_ell, sol_dense, iters=iters, reps=reps,
            what=f"{tag} ell")
        out.update(ell_ms=mse, gemmell_pair_ms=gpe, pair_spreadell=spreade)
        if spe == spe:
            out["ell_speedup"] = spe
        out["ell_tflops"] = flops / (mse * 1e9)

    out.update(sol24_ms=sol24, sol_speedup=sol_dense / sol24,
               ell_sol_ms=sol_ell, prune_sol_ms=sol_prune,
               compress_sol_ms=sol_compress, fused_sol_ms=sol_fused,
               pack_sol_ms=sol_pack)
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
    on_shape: Optional[Callable[[LayerShape, Dict], None]] = None,
) -> List[ShapeResult]:
    """Sweep shapes (deduplicated), returning one result per input layer;
    ``on_shape(shape, result)`` is called after each unique shape."""
    cache: Dict[LayerShape, Dict[str, float]] = {}
    results = []
    for i, sh in enumerate(shapes):
        if sh not in cache:
            cache[sh] = bench_shape(sh, dtype=dtype, kernels=kernels,
                                    iters=iters, reps=reps, device=device,
                                    verbose=verbose)
            if on_shape is not None:
                on_shape(sh, cache[sh])
            if verbose:
                design = cache[sh].get("spmm24_design")
                print(f"[{len(cache):3d} uniq] m={sh.m:6d} n={sh.n:5d} "
                      f"k={sh.k:5d} b={sh.b}  " + " ".join(
                          f"{kk}={vv:.4f}" for kk, vv in cache[sh].items()
                          if kk.endswith("_ms"))
                      + (f" spmm24_design={design}" if design else ""),
                      flush=True)
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
        "pack_ms_geomean": geomean([r.pack_ms for r in results]),
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
    on_shape: Optional[Callable[[LayerShape, Dict], None]] = None,
):
    shapes = resnet_conv_shapes(model)
    if max_layers:
        shapes = shapes[:max_layers]
    results = sweep(shapes, dtype=dtype, kernels=kernels, iters=iters,
                    reps=reps, device=device, verbose=verbose,
                    on_shape=on_shape)
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
