"""What several per-layer metric readers share: a span's device time over
the traced passes, and the bound of the same calls."""

from __future__ import annotations

from typing import Callable, Optional

SPAN = "perfbench."


def span_time(trace: Optional[dict], stage: str, kind: str = "all"):
    """``(device seconds, span count)`` of a stage's spans in one rank's
    traced window, or ``None`` where the trace saw no device time there."""
    if not trace:
        return None
    sp = trace["spans"].get(SPAN + stage)
    if not sp or not sp[kind + "_s"] > 0 or not sp["count"]:
        return None
    return sp[kind + "_s"], sp["count"]


def roofline_share(run, stages, bound: Callable, kind: str = "all"):
    """The traced passes' least time over the device time of the stages'
    spans, in %, summed over every rank: ``bound(rows, n, k)`` is one
    layer's least time in seconds for all the stages together, and each
    stage runs once a layer a pass."""
    total_bound = total_time = 0.0
    for trace in run.traces:
        for i, stage in enumerate(stages):
            got = span_time(trace, stage, kind)
            if got is None:
                return None
            seconds, count = got
            total_time += seconds
            if i == 0:
                passes = count / len(run.layers)
                total_bound += passes * sum(bound(*layer)
                                            for layer in run.layers)
    return 100.0 * total_bound / total_time
