"""Offline kernel tuner: writes ``tuning_table.json`` on the card.

Counterpart of ``sparsifyme_tpu.bench.tune`` (the ``cusparseLtMatmulSearch``
analog, run once per card instead of per benchmark, ``cusparseLt.h:262-277``):
for every unique layer shape of a model sweep it races the candidate
configurations of each op family with the timer the benchmark uses
(``utils.timing``) and writes the winners to the table (:mod:`.tuning`),
with the card that measured them.

The candidates are the port's knobs, not the TPU's tiles:

* ``gemm``: ``fold`` True / False (one tall product or the batched call);
* ``spmm24``: every tile of ``spmm24_kernel.SP_TILES`` in both output
  layouts; packed codes in both layouts where ``k <= 1024``; the fold=2
  route where ``k4 <= 256`` and ``b * m`` is even;
* ``fused``: fold 1, and fold 2 where ``k <= 160`` and ``b * m`` is even;
* ``ell``: the JAX tuner's block edges (heuristic, alternative, no-pad)
  that K4/K5 take (:data:`~..ops.kernels.ell_kernel.BLOCK_KS`), the
  ``fold_first`` layout where it removes m-padding, then K4 in both
  layouts under ``ell_plan``'s pick, its runner-up width and its runner-up
  split count (``--full``: every plan the tile admits), and K5 in both
  layouts where ``k <= 1024`` at the heuristic edge.

A candidate that cannot run is left out here, in Python, before anything
is launched; a launch that fails stops the tuner (a failed launch can leave
the CUDA context unusable for every later candidate). A reading under 0.85x
its bound (:mod:`.roofline`) is re-measured once and, if it is still under,
discarded and printed with its shape and candidate.

Usage::

    python -m sparsifyme_tpu_torch.bench.tune [--model resnet50]
        [--ops gemm,spmm24,ell,fused] [--shapes 3136x128x1152x32,...]
        [--fresh] [--full] [--iters 8] [--reps 2] [--table PATH]
        [--budget-s S]

The table is saved after every shape, so an interrupted run keeps its
progress.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import subprocess
import sys
import time
from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

from .. import _build
from ..models.resnet_shapes import resnet_conv_shapes
from ..ops.kernels import ell_kernel
from ..ops.kernels.spmm24_kernel import (H100_SMS, SP_TILES, pick_tile,
                                         sm_count)
from ..ops.prune import prune_nm
from ..ops.sparse24 import compress_24, prune_compress_24
from ..ops.gemm import batched_gemm
from . import harness
from .roofline import dense_sol_ms, ell_sol_ms, fused_sol_ms, spmm24_sol_ms
from .tuning import TABLE_PATH, load_table, save_table, shape_key

OPS = ("gemm", "spmm24", "ell", "fused")


@dataclasses.dataclass
class TuneLog:
    """What a tuning run raced: candidates timed per family, and the
    readings discarded under their bound (``"<shape> <family>
    <candidate>"``)."""

    candidates: Dict[str, int] = dataclasses.field(default_factory=dict)
    discards: List[str] = dataclasses.field(default_factory=list)


def card_line(device: torch.device) -> str:
    """``nvidia-smi --query-gpu=name,power.limit`` of the card that holds
    ``device``; ``cpu`` for CPU tensors."""
    if device.type != "cuda":
        return "cpu"
    index = (device.index if device.index is not None
             else torch.cuda.current_device())
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", str(index)],
        check=True, capture_output=True, text=True).stdout.strip()


def _round_up(a: int, b: int) -> int:
    return -(-a // b) * b


def _k4(k: int) -> int:
    """Groups of the planes: k padded to a multiple of 64, over 4."""
    return _round_up(k, 64) // 4


def gemm_candidates() -> List[Dict]:
    return [{"fold": True}, {"fold": False}]


def spmm24_candidates(m: int, n: int, k: int, b: int,
                      full: bool = False) -> List[Dict]:
    """Every tile in both layouts; packed codes in both layouts where
    ``k <= 1024`` (and the group count is even); the fold=2 route where
    ``k4 <= 256`` and ``b * m`` is even. Packed and fold take
    ``pick_tile``'s tile, or (``full``) every tile."""
    tiles = range(len(SP_TILES))
    cands = [{"tile": t, "transpose_out": tr, "packed": False, "fold": 1}
             for t in tiles for tr in (False, True)]
    extra = tiles if full else (None,)
    if k <= 1024 and _k4(k) % 2 == 0:
        cands += [{"tile": t, "transpose_out": tr, "packed": True, "fold": 1}
                  for t in extra for tr in (False, True)]
    if _k4(k) <= 256 and (b * m) % 2 == 0:
        cands += [{"tile": t, "transpose_out": False, "packed": False,
                   "fold": 2} for t in extra]
    return cands


def fused_candidates(m: int, k: int, b: int) -> List[Dict]:
    """Fold 1, and fold 2 where ``k <= 160`` and ``b * m`` is even (JAX
    ``tune.py:237-243``)."""
    cands = [{"fold": 1}]
    if k <= 160 and (b * m) % 2 == 0:
        cands.append({"fold": 2})
    return cands


def ell_edges(k: int, full: bool = False) -> List[int]:
    """The JAX tuner's block edges (``tune.py:265-295``): the heuristic,
    one alternative (``full``: two) and the largest edge that pads k the
    least, restricted to the edges K4/K5 take. JAX's wide edges (256,
    512) are not among them."""
    heur = harness.heuristic_block_k(k)
    if full:
        alt = ({64} if 128 <= k < 512 else
               ({32, 128} if k < 1536 else {64}))
    else:
        alt = ({64} if 128 <= k < 512 else ({128} if k < 1536 else {64}))
    edges = ell_kernel.BLOCK_KS
    min_len = min(_round_up(k, 2 * x) // 2 for x in edges)
    nopad = max(x for x in edges if _round_up(k, 2 * x) // 2 == min_len)
    return sorted(({heur, nopad} | alt) & set(edges))


def ell_rows(m: int, b: int, fold_first: bool) -> int:
    """Rows of the batch-folded ELL operand of ``build_ell_operand``."""
    return (_round_up(b * m, 128) if fold_first
            else b * _round_up(m, 128))


def ell_plans(rows: int, n: int, ell: int, bk: int, full: bool = False,
              sms: int = H100_SMS) -> List[tuple]:
    """``(block_n, splits)`` of the plans raced for K4: ``ell_plan``'s
    pick, the plan it picks among the other widths and among the other
    split counts at the pick's width; ``full``: every plan the tile
    admits. ``[(None, None)]`` where the tile does not apply (the simple
    kernels run)."""
    def plan(widths=ell_kernel.TILE_NS, splits=None):
        return ell_kernel.ell_plan(rows, n, ell, bk, 128, sms, widths,
                                   splits)

    pick = plan()
    if pick is None:
        return [(None, None)]
    if full:
        found = [(bn, s) for bn in ell_kernel.TILE_NS
                 for s in range(1, ell_kernel.MAX_SPLITS + 1)
                 if plan((bn,), (s,)) is not None]
        return [(pick.bn, pick.splits)] + [
            p for p in found if p != (pick.bn, pick.splits)]
    out = [(pick.bn, pick.splits)]
    others = tuple(w for w in ell_kernel.TILE_NS if w != pick.bn)
    alt_width = plan(others) if others else None
    alt_split = plan((pick.bn,), tuple(
        s for s in range(1, ell_kernel.MAX_SPLITS + 1) if s != pick.splits))
    for p in (alt_width, alt_split):
        if p is not None and (p.bn, p.splits) not in out:
            out.append((p.bn, p.splits))
    return out


def ell_candidates(m: int, n: int, k: int, b: int, full: bool = False,
                   sms: int = H100_SMS) -> List[Dict]:
    """Every ELL candidate, in the schema of the table's ``ell`` entry."""
    heur = harness.heuristic_block_k(k)
    can_fold = harness.can_fold_first(m, b)
    ffs = ((False, True) if (full and can_fold)
           else ((True,) if can_fold else (False,)))
    cands = []
    for bkb in ell_edges(k, full):
        ell = max(1, (_round_up(k, 2 * bkb) // bkb) // 2)
        for ff in ffs:
            base = {"block_size": 128, "block_k": bkb, "fold_first": ff}
            for bn, splits in ell_plans(ell_rows(m, b, ff), n, ell, bkb,
                                        full, sms):
                cands += [dict(base, formulation="gather", transpose_out=tr,
                               block_n=bn, splits=splits)
                          for tr in (False, True)]
            if k <= 1024 and (full or bkb == heur):
                cands += [dict(base, formulation="expand", transpose_out=tr,
                               block_n=None, splits=None)
                          for tr in (False, True)]
    return cands


def _time(fn, operands, iters: int, reps: int, floor_ms: float, what: str,
          log: TuneLog) -> float:
    """One candidate's ms: :func:`harness._guarded`, and a reading still
    under 0.85x the bound after its re-measure is discarded (``inf``) and
    printed: a candidate that cannot be timed credibly must not win."""
    ms = harness._guarded(fn, operands, floor_ms, iters=iters, reps=reps,
                          what=what).ms
    if ms < harness.SUB_BOUND * floor_ms:
        print(f"      {what}: {ms:.4f} ms still under {harness.SUB_BOUND} x"
              f" bound {floor_ms:.4f} ms: discarded", flush=True)
        log.discards.append(what)
        return math.inf
    return ms


def _race(family: str, cands: Sequence[Dict], make, floor_ms, tag: str,
          iters: int, reps: int, log: TuneLog, readings: List) -> None:
    """Time each candidate (``make(cand) -> (fn, operands)``; ``floor_ms``
    a number or ``floor_ms(cand)``) and append ``(cand, ms)`` to
    ``readings``."""
    for cand in cands:
        floor = floor_ms(cand) if callable(floor_ms) else floor_ms
        fn, ops = make(cand)
        ms = _time(fn, ops, iters, reps, floor, f"{tag} {family} {cand}",
                   log)
        print(f"    {family} {cand}: {ms:.4f} ms", flush=True)
        readings.append((cand, ms))
    log.candidates[family] = log.candidates.get(family, 0) + len(cands)


def _winner(family: str, readings: List,
            today: Sequence[Dict] = ()) -> Optional[Dict]:
    """The fastest reading with its ``ms`` (None where every reading was
    discarded), printed beside the best of ``today``'s candidates: what
    the untuned harness races."""
    best, best_ms = min(readings, key=lambda r: r[1], default=(None,
                                                               math.inf))
    if best is None or best_ms == math.inf:
        print(f"    {family}: every reading discarded, no entry",
              flush=True)
        return None
    best = dict(best, ms=round(best_ms, 5))
    print(f"    winner {family}: {best}", flush=True)
    old = [r for r in readings if r[0] in today]
    if old:
        cand, ms = min(old, key=lambda r: r[1])
        print(f"    today {family}: {cand}: {ms:.5f} ms (winner "
              f"{best_ms / ms:.3f}x of it)", flush=True)
    return best


def tune_shape(m: int, n: int, k: int, b: int, ops: Sequence[str] = OPS, *,
               iters: int = 8, reps: int = 2,
               dtype: torch.dtype = torch.bfloat16, full: bool = False,
               device=None, log: Optional[TuneLog] = None) -> Dict:
    """Race every family of ``ops`` at one shape (A ``(b, m, k)`` and B
    ``(k, n)`` from seed 0 on ``device``, ``None``: the GPU) and return
    its table entry, the winners with their ``ms`` and the ``card``."""
    dev = _build.resolve_device(device)
    log = TuneLog() if log is None else log
    gen = torch.Generator(device=dev).manual_seed(0)
    a = torch.randn((b, m, k), generator=gen, device=dev).to(dtype)
    bm = torch.randn((k, n), generator=gen, device=dev).to(dtype)
    tag = shape_key(m, n, k, b)
    sms = sm_count(dev.index if dev.index is not None
                   else torch.cuda.current_device()) \
        if dev.type == "cuda" else H100_SMS
    entry: Dict = {}

    def put(family, winner):
        if winner is not None:
            entry[family] = winner

    if "gemm" in ops:
        readings = []
        _race("gemm", gemm_candidates(),
              lambda c: (lambda x, y: batched_gemm(
                  x, y, out_dtype=dtype, fold=c["fold"]), (a, bm)),
              dense_sol_ms(m, n, k, b), tag, iters, reps, log, readings)
        put("gemm", _winner("gemm", readings, gemm_candidates()))

    if "spmm24" in ops:
        cands = spmm24_candidates(m, n, k, b, full)
        pruned = prune_nm(a, 2, 4)[0]
        s = compress_24(pruned)
        s_fold = (prune_compress_24(pruned, fold=2)
                  if any(c["fold"] == 2 for c in cands) else None)
        del pruned
        readings = []
        _race("spmm24", cands,
              lambda c: harness.spmm24_call(c, s, s_fold, bm, dtype),
              lambda c: spmm24_sol_ms(m, n, k, b, packed_codes=c["packed"]),
              tag, iters, reps, log, readings)
        del s, s_fold
        pick = pick_tile(b * m, n, k, 1, sms)
        put("spmm24", _winner("spmm24", readings, [
            {"tile": pick, "transpose_out": tr, "packed": False, "fold": 1}
            for tr in (False, True)]))

    if "fused" in ops:
        readings = []
        _race("fused", fused_candidates(m, k, b),
              lambda c: (lambda x: prune_compress_24(x, fold=c["fold"]),
                         (a,)),
              fused_sol_ms(m, k, b), tag, max(4, iters // 2), reps, log,
              readings)
        put("fused", _winner("fused", readings, [{"fold": 1}]))

    if "ell" in ops:
        cands = ell_candidates(m, n, k, b, full, sms)
        readings = []
        # one operand per (edge, layout), built before its candidates
        for key in dict.fromkeys((c["block_k"], c["fold_first"])
                                 for c in cands):
            e, kp = harness.build_ell_operand(a, block_size=128,
                                              block_k=key[0],
                                              fold_first=key[1])
            bp = F.pad(bm, (0, 0, 0, kp - k))
            _race("ell", [c for c in cands
                          if (c["block_k"], c["fold_first"]) == key],
                  lambda c: harness.ell_call(c, e, bp, dtype),
                  ell_sol_ms(m, n, k, b), tag, iters, reps, log, readings)
            del e, bp
        # the untuned race: the heuristic edge and layout, K4 under
        # ell_plan's pick in both layouts (and K5 where k < 512)
        bkb = harness.heuristic_block_k(k)
        ff = harness.can_fold_first(m, b)
        ell = max(1, (_round_up(k, 2 * bkb) // bkb) // 2)
        bn, splits = ell_plans(ell_rows(m, b, ff), n, ell, bkb, False,
                               sms)[0]
        base = {"block_size": 128, "block_k": bkb, "fold_first": ff}
        today = [dict(base, formulation="gather", transpose_out=tr,
                      block_n=bn, splits=splits) for tr in (False, True)]
        if k < 512:
            today += [dict(base, formulation="expand", transpose_out=tr,
                           block_n=None, splits=None)
                      for tr in (False, True)]
        put("ell", _winner("ell", readings, today))

    entry["card"] = card_line(dev)
    return entry


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--model", default="resnet50")
    p.add_argument("--ops", default=",".join(OPS))
    p.add_argument("--iters", type=int, default=8)
    p.add_argument("--reps", type=int, default=2)
    p.add_argument("--table", default=TABLE_PATH)
    p.add_argument("--fresh", action="store_true",
                   help="ignore existing entries (default: skip shapes "
                        "already tuned for the requested ops)")
    p.add_argument("--full", action="store_true",
                   help="wide candidate grid: every ELL plan the tile "
                        "admits, both ELL layouts, packed and fold=2 at "
                        "every tile")
    p.add_argument("--budget-s", type=float, default=None,
                   help="wall-clock budget; stop starting new shapes "
                        "after this many seconds (the table stays partial: "
                        "the harness races its untuned candidates for the "
                        "shapes without an entry)")
    p.add_argument("--shapes", default=None,
                   help="comma-separated mxnxkxb keys (e.g. "
                        "784x256x2304x32): tune only these")
    args = p.parse_args(argv)
    ops = tuple(args.ops.split(","))

    shapes = sorted(set(resnet_conv_shapes(args.model)))
    if args.shapes:
        want = set(args.shapes.split(","))
        shapes = [s for s in shapes
                  if shape_key(s.m, s.n, s.k, s.b) in want]
    table = dict(load_table(args.table))
    log = TuneLog()
    t0 = time.time()
    _build.build_all()  # before the first shape, so that no timing waits
    print(f"build: {time.time() - t0:.1f} s", flush=True)
    t0 = time.time()
    for i, s in enumerate(shapes):
        key = shape_key(s.m, s.n, s.k, s.b)
        have = table.get(key, {})
        todo = [o for o in ops if args.fresh or o not in have]
        if not todo:
            print(f"[{i + 1}/{len(shapes)}] {key}: already tuned",
                  flush=True)
            continue
        if args.budget_s and time.time() - t0 > args.budget_s:
            print(f"[{i + 1}/{len(shapes)}] {key}: skipped, tune budget "
                  f"{args.budget_s:.0f} s spent", flush=True)
            continue
        print(f"[{i + 1}/{len(shapes)}] {key}: tuning {todo} "
              f"(t={time.time() - t0:.0f} s)", flush=True)
        entry = tune_shape(s.m, s.n, s.k, s.b, todo, iters=args.iters,
                           reps=args.reps, full=args.full, log=log)
        table[key] = {**have, **entry}
        save_table(table, args.table)  # after every shape
    print(f"done in {time.time() - t0:.1f} s -> {args.table}; candidates "
          f"{log.candidates}; discarded {len(log.discards)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
