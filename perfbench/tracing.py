"""Reading a profiler trace: the benchmark's own spans, the device's
activity, and which span launched what.

The trace is ``torch.profiler``'s chrome trace. Spans are the
``record_function("perfbench.<stage>")`` ranges that the benchmark opens
around its calls into the program. A device event (kernel, copy or set)
belongs to the innermost span that was open on the host thread when its
launch was made, matched by the launch's correlation id, so kernels are
never picked by name: a renamed or fused kernel counts where it ran. Only
the exchange is told apart by name, as the communication library's
kernels (``nccl``), and copies and sets by the trace's own categories.
"""

from __future__ import annotations

import bisect
import json
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Tuple

PREFIX = "perfbench."
WINDOW = PREFIX + "window"
DEVICE_CATS = {"kernel": "compute", "gpu_memcpy": "copy",
               "gpu_memset": "copy"}
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
TOP = 10


def union_length(intervals: Iterable[Tuple[float, float]]) -> float:
    """Total length covered by the union of ``(start, end)`` intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def merged(intervals: Iterable[Tuple[float, float]]) -> List[List[float]]:
    """The union of intervals as disjoint, sorted ``[start, end]``."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class SpanIndex:
    """The benchmark's spans on one thread, by nesting depth, so that the
    innermost span open at a time is found by bisection."""

    def __init__(self, spans: List[Tuple[float, float, str]]):
        levels: List[List[Tuple[float, float, str]]] = []
        stack: List[Tuple[float, float, str]] = []
        for s, e, name in sorted(spans, key=lambda x: (x[0], -x[1])):
            while stack and stack[-1][1] <= s:
                stack.pop()
            depth = len(stack)
            while len(levels) <= depth:
                levels.append([])
            levels[depth].append((s, e, name))
            stack.append((s, e, name))
        self.levels = [([x[0] for x in lv], lv) for lv in levels]

    def at(self, t: float) -> Optional[str]:
        for starts, lv in reversed(self.levels):
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and lv[i][1] >= t:
                return lv[i][2]
        return None


def kind_of(cat: str, name: str) -> str:
    if "nccl" in name.lower():
        return "nccl"
    return DEVICE_CATS[cat]


def summarize(events: List[dict]) -> dict:
    """The traced window's summary from chrome-trace events: its length,
    the device's busy time in it, per span name the device time of what
    the spans launched (in all and by kind), the device operations that
    took most time, and the idle gaps named by the span the host was in.
    Seconds throughout."""
    spans: Dict[object, List[Tuple[float, float, str]]] = defaultdict(list)
    launches: Dict[int, Tuple[object, float]] = {}
    device: List[Tuple[float, float, str, str, Optional[int]]] = []
    window = None
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat, name = ev.get("cat", ""), ev.get("name", "")
        ts, dur = float(ev.get("ts", 0.0)), float(ev.get("dur", 0.0))
        tid = (ev.get("pid"), ev.get("tid"))
        args = ev.get("args") or {}
        if cat == "user_annotation" and name.startswith(PREFIX):
            spans[tid].append((ts, ts + dur, name))
            if name == WINDOW:
                window = (ts, ts + dur, tid)
        elif cat in LAUNCH_CATS and "correlation" in args:
            launches[int(args["correlation"])] = (tid, ts)
        elif cat in DEVICE_CATS:
            corr = args.get("correlation")
            device.append((ts, ts + dur, name, cat,
                           None if corr is None else int(corr)))
    if window is None:
        return {"window_s": 0.0, "busy_s": 0.0, "spans": {},
                "device_ops": [], "idle_gaps": []}
    w0, w1, host_tid = window
    index = {tid: SpanIndex(sp) for tid, sp in spans.items()}
    by_span: Dict[str, Dict[str, List[Tuple[float, float]]]] = defaultdict(
        lambda: defaultdict(list))
    per_op: Dict[str, float] = defaultdict(float)
    busy: List[Tuple[float, float]] = []
    for s, e, name, cat, corr in device:
        s, e = max(s, w0), min(e, w1)
        if e <= s:
            continue
        busy.append((s, e))
        per_op[name] += e - s
        launch = launches.get(corr) if corr is not None else None
        owner = None
        if launch is not None and launch[0] in index:
            owner = index[launch[0]].at(launch[1])
        owner = owner or "unattributed"
        kind = kind_of(cat, name)
        by_span[owner][kind].append((s, e))
        by_span[owner]["all"].append((s, e))
    counts: Dict[str, int] = defaultdict(int)
    for sp in spans.values():
        for s, e, name in sp:
            if w0 <= s and e <= w1:
                counts[name] += 1
    span_out = {}
    for name in set(by_span) | set(counts):
        kinds = by_span.get(name, {})
        span_out[name] = {"count": counts.get(name, 0)}
        for kind in ("all", "compute", "copy", "nccl"):
            span_out[name][kind + "_s"] = union_length(
                kinds.get(kind, ())) * 1e-6
    busy_m = merged(busy)
    gaps: Dict[str, float] = defaultdict(float)
    host = index.get(host_tid)
    t = w0
    for s, e in busy_m + [[w1, w1]]:
        if s > t:
            owner = (host.at(t) if host else None) or "outside any span"
            gaps[owner] += s - t
        t = max(t, e)
    top = lambda d: [[k, v * 1e-6] for k, v in sorted(
        d.items(), key=lambda kv: -kv[1])[:TOP]]
    return {"window_s": (w1 - w0) * 1e-6,
            "busy_s": union_length(busy) * 1e-6,
            "spans": span_out, "device_ops": top(per_op),
            "idle_gaps": top(gaps)}


def summarize_file(path: str) -> dict:
    with open(path) as f:
        trace = json.load(f)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    return summarize(events)
