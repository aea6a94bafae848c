"""Where K7's ring time goes on the H100, by step design and plan.

At R (784x256x1024, b = 32: 25088 folded rows over P = 4 ranks of one
card, bf16, the container packed once with ``pack_wg``):

* ``step``: one step of rank 1 alone, calls replayed in a CUDA graph
  (``utils.timing.time_graph``), each design on the plain route's window
  (6272 columns) and on the tiled route's (896, at column 2688), as a
  first step (no accumulator read), a middle one and a last one (bf16 C),
  beside the step's byte bound: A's window (1.125 B a logical element as
  packed, 1.25 as planes), the slot, and the accumulator read and written;
* ``ring``: both routes' whole rings per design, the captured ring
  replayed (``utils.timing.time_kernel``, which warms each replica twice),
  and ``none``: the same rings with every step a no-op, what the ring costs
  beside K7 (staging, the slots' copies, the events, C's copy out);
* ``--plans``: the wgmma_sp step and rings under every tile width and
  split count the tile takes (``ring_kernel.card_ring_wg_plan`` rebound);
* ``--reps N``: the rings alone, the wgmma_sp step under its plan, at 64
  and at 128 columns, the mma_sp step and no step, interleaved N times,
  each reading with the host's time to queue a replay (``enqueue_ms``),
  then each case's median, range and ratio to the mma_sp step.

Usage (needs one GPU; runs against any tree of the port with K7's
``wgmma_sp`` step, e.g. ``cd .chip_archive/parent && PYTHONPATH=$PWD python
<this tree's probe>``)::

    python -m sparsifyme_tpu_torch.bench.ring_probe [--plans | --reps N]

Prints one JSON line per measurement, then the card line.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import statistics
import subprocess
import time

import torch

M, N, K, BATCH, P = 784, 256, 1024, 32, 4
HBM_BYTES_PER_MS = 3.35e9  # the H100 SXM data sheet's 3.35 TB/s
PLANS = [(bn, splits) for bn in (64, 128) for splits in (1, 2, 4)]
STEPS = {"ring_step_cuda": "mma_sp", "ring_step_tiled_cuda": "mma_sp",
         "ring_step_wg_cuda": "wgmma_sp",
         "ring_step_wg_tiled_cuda": "wgmma_sp"}


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def operands(gen):
    """A ``[25088, 1024]`` pruned, compressed and packed on the card, and B
    ``[1024, 256]``, bf16."""
    from .. import compress_24, prune_nm
    from ..ops.sparse24 import pack_wg

    a = torch.randn((BATCH * M, K), generator=gen, device="cuda").to(
        torch.bfloat16)
    b = torch.randn((K, N), generator=gen, device="cuda").to(torch.bfloat16)
    return pack_wg(compress_24(prune_nm(a)[0])), b


@contextlib.contextmanager
def forced(bn=None, splits=None, none=False):
    """The wgmma_sp step under the plan of ``bn`` columns and ``splits``
    splits (``None``: ``ring_wg_plan``'s), or every step a no-op
    (``none``); the ring-graph cache emptied around it."""
    from ..ops.kernels.spmm24_kernel import wg_forced_plan
    from ..parallel import ring_graph
    from ..parallel import ring_kernel as rk

    saved = {name: getattr(rk, name) for name in STEPS}
    saved_plan = rk.card_ring_wg_plan
    if bn or splits:
        def plan(index, mt, n, k):
            pick = rk.ring_wg_plan(mt, n, k)
            return wg_forced_plan(mt, n, k, bn or pick.bn,
                                  splits or pick.splits)
        rk.card_ring_wg_plan = plan
    if none:
        def noop(*args, **kw):
            pass
        noop.launches = 0
        for name in STEPS:
            setattr(rk, name, noop)
    ring_graph.clear()
    try:
        yield
    finally:
        rk.card_ring_wg_plan = saved_plan
        for name, fn in saved.items():
            setattr(rk, name, fn)
        ring_graph.clear()


def step_bytes(mt: int, k: int, design: str, first: bool,
               last: bool) -> float:
    """What one step must move: A's window, the slot, the accumulator
    (read unless first, written unless last) and bf16 C on the last."""
    a = mt * k * (1.125 if design == "wgmma_sp" else 1.25)
    per_c = (0 if first else 4) + (2 if last else 4)
    return a + 2.0 * k * N + per_c * mt * N


def steps(s, gen, plans) -> None:
    from ..parallel import ring_kernel as rk
    from ..utils.timing import time_graph

    rows, k4 = s.values0.shape[1], s.values0.shape[0]
    mloc, k4s, r = rows // P, k4 // P, 1
    k = 4 * k4s
    planes = [x[:, r * mloc:(r + 1) * mloc]
              for x in (s.values0, s.values1, s.codes)]
    a_wg = (s.wg.packed, r * mloc // 128)
    slot = torch.randn((k, N), generator=gen, device="cuda").to(
        torch.bfloat16)
    acc = torch.randn((mloc, N), generator=gen, device="cuda")
    out = torch.empty((mloc, N), dtype=torch.bfloat16, device="cuda")
    mt_tiled = rk._pick_mt(mloc)
    cases = [(design, bn, splits) for design in ("wgmma_sp", "mma_sp")
             for bn, splits in (plans if design == "wgmma_sp"
                                else [(None, None)])]
    for route, c0, mt in (("plain", 0, mloc),
                          ("tiled", 3 * mt_tiled, mt_tiled)):
        for design, bn, splits in cases:
            a = a_wg if design == "wgmma_sp" else planes
            fn = rk.ring_step_wg_cuda if design == "wgmma_sp" \
                else rk.ring_step_cuda
            for flag, first, last in (("first", True, False),
                                      ("middle", False, False),
                                      ("last", False, True)):
                def call(sl, fn=fn, a=a, c0=c0, mt=mt, first=first,
                         last=last):
                    fn(*a, sl, acc, out, src=0, c0=c0, mt=mt, first=first,
                       last=last)
                with forced(bn, splits):
                    ms = time_graph(call, (slot,), iters=20, reps=5).ms
                byts = step_bytes(mt, k, design, first, last)
                print(json.dumps({
                    "step": route, "design": design, "bn": bn,
                    "splits": splits, "flag": flag,
                    "shape": f"{mt}x{N}x{k}", "device_ms": ms,
                    "bytes": byts, "bound_ms": byts / HBM_BYTES_PER_MS}),
                    flush=True)


def _enqueue_ms(fn, ops, calls=10) -> float:
    """The host's time to queue one call without waiting for the card."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn(*ops)
    ms = (time.perf_counter() - t0) * 1e3 / calls
    torch.cuda.synchronize()
    return ms


def rings(s, b, plans, reps: int = 1) -> None:
    """Each route's ring under every case, the cases interleaved ``reps``
    times (a rep times each case once, so a drift of the card's or the
    host's state reaches every case alike); one line per reading with the
    host's time to queue a replay beside it, then, where ``reps`` > 1, one
    line per case with the median, least and most of its readings and the
    median and range of its per-rep ratio to the ``mma_sp`` step."""
    from .. import make_mesh, spmm_24_ring_explicit, spmm_24_ring_tiled
    from ..utils.timing import time_kernel

    mesh = make_mesh((P,), ("model",), devices=["cuda:0"] * P)
    cases = ([("wgmma_sp", bn, splits, False) for bn, splits in plans]
             + [("mma_sp", None, None, False), ("none", None, None, True)])
    for route, fn in (("plain", spmm_24_ring_explicit),
                      ("tiled", spmm_24_ring_tiled)):
        def ring(ss, y, fn=fn, design=None):
            return fn(ss, y, mesh, "model", design=design)
        seen = {case: [] for case in cases}
        for rep in range(reps):
            for case in cases:
                design, bn, splits, none = case
                call = functools.partial(
                    ring, design=None if none else design)
                with forced(bn, splits, none):
                    ms = time_kernel(call, (s, b), iters=20, reps=5).ms
                    enq = _enqueue_ms(call, (s, b))
                seen[case].append(ms)
                print(json.dumps({"ring": route, "design": design, "bn": bn,
                                  "splits": splits, "rep": rep, "ms": ms,
                                  "enqueue_ms": enq}), flush=True)
        if reps < 2:
            continue
        base = seen[("mma_sp", None, None, False)]
        for (design, bn, splits, _), got in seen.items():
            ratios = sorted(a / m for a, m in zip(got, base))
            print(json.dumps({
                "ring": route, "design": design, "bn": bn,
                "splits": splits, "reps": reps,
                "median_ms": statistics.median(got), "min_ms": min(got),
                "max_ms": max(got),
                "ratio_to_mma_sp": statistics.median(ratios),
                "ratio_min": ratios[0], "ratio_max": ratios[-1]}),
                flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--plans", action="store_true",
                    help="every tile width and split count of the "
                         "wgmma_sp step")
    ap.add_argument("--reps", type=int, default=1,
                    help="rings only: the cases interleaved this many "
                         "times, the plan's and each tile width's")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("ring_probe needs a CUDA card")
    gen = torch.Generator(device="cuda").manual_seed(0)
    s, b = operands(gen)
    with torch.no_grad():
        if args.reps > 1:
            rings(s, b, [(None, None), (64, None), (128, None)], args.reps)
        else:
            plans = PLANS if args.plans else [(None, None)]
            steps(s, gen, plans)
            rings(s, b, plans)
    print(card_line(), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
