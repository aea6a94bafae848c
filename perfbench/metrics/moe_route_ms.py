"""moe_route_ms: a MoE model's routing and combining, device ms a pass:
the device time in its ``moe_route`` and ``moe_combine`` spans (router
product, selection, grouping by expert, the weighted scatter back) over
the traced passes."""

from perfbench.metrics._common import span_time


def read(run):
    total = 0.0
    for stage in ("moe_route", "moe_combine"):
        got = span_time(run.traces[0], stage)
        if got is None:
            return None
        total += got[0]
    return 1e3 * total / run.trace_passes
