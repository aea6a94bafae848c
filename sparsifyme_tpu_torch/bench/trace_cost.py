"""The host cost of the span recorder (``utils.trace``) on one public call.

Times the span machinery alone, as one ``spmm_24`` call on the card runs
it (its entry, five phase marks and the end), ``n`` times, less the same
function without it: with recording off, which every call pays, and
inside ``trace.recording()``. Prints one JSON line of nanoseconds a
call; the spans recorded are dropped again (``trace.reset()``). The
machinery is pure Python, so the reading is the host's, whatever device
the program drives.

A measurement script: the port does not import it.

Usage: python -m sparsifyme_tpu_torch.bench.trace_cost [n]
"""

from __future__ import annotations

import json
import sys
import time

from ..utils import trace

MARKS = 5  # design, prep, plan, alloc, launch


def one_call() -> None:
    """The recorder's work in one ``spmm_24`` call on the card: its entry,
    five marks and the end."""
    call = trace.begin("sparsifyme.spmm_24", "check_wg")
    try:
        trace.mark("design")
        trace.mark("prep")
        trace.mark("plan")
        trace.mark("alloc")
        trace.mark("launch")
    finally:
        if call:
            trace.end(call)


def bare_call() -> None:
    """:func:`one_call` without the recorder: the baseline taken off."""
    call = None
    try:
        pass
    finally:
        if call:
            pass


def _per_call_ns(n: int, reps: int) -> float:
    """The least over ``reps`` of ns a call, less :func:`bare_call`'s."""
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter_ns()
        for _ in range(n):
            one_call()
        t1 = time.perf_counter_ns()
        for _ in range(n):
            bare_call()
        t2 = time.perf_counter_ns()
        best = min(best, ((t1 - t0) - (t2 - t1)) / n)
    return best


def measure(n: int = 100_000, reps: int = 5) -> dict:
    """ns a call with recording off and on; the spans recorded on are
    dropped again."""
    off = _per_call_ns(n, reps)
    with trace.recording():
        on = _per_call_ns(n, 1)
    spans = trace.summary()["spans"]
    recorded = sum(s["count"] for s in spans.values())
    trace.reset()
    return {"calls": n, "off_ns_per_call": off, "on_ns_per_call": on,
            "spans_per_call": recorded / n,
            "marks_per_call": MARKS}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    n = int(argv[0]) if argv else 100_000
    print(json.dumps({"trace_cost": measure(n)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
