"""expert_roofline: the held experts' K3 calls (the ``experts`` spans of a
MoE model's traced passes): their least time over their device time, in
%. The least time is the larger of their kept products over the rows
really routed here (the program's counter ``moe.rows``) at the bf16 peak
and their bytes (every held expert's weights at the 2:4 format's 1.125 B
a logical element once a layer, each row's B and C) at HBM bandwidth,
counted by the route file (``expert_flops``, ``expert_bytes``). None where
the program counts no rows (it has no such counter) or the trace saw no
device time there."""

from perfbench import roofline
from perfbench.metrics._common import span_time
from perfbench.metrics.dispatch_us import PREFIX, program_spans


def program_counters():
    try:
        from sparsifyme_tpu_torch.utils import trace
    except ImportError:
        return {}
    summary = getattr(trace, "summary", None)
    return summary().get("counters", {}) if summary is not None else {}


def read(run):
    spans = program_spans(run)
    rows = program_counters().get("moe.rows")
    calls = (spans or {}).get(PREFIX + "moe", {}).get("count")
    got = span_time(run.traces[0], "experts")
    flops = getattr(run.route, "expert_flops", None)
    if not rows or not calls or got is None or flops is None:
        return None
    seconds, layers = got  # one experts span a MoE layer
    rows = rows / calls * layers  # the traced window's rows
    least = roofline.bound_s(flops(run.config, rows),
                             run.route.expert_bytes(run.config, rows, layers))
    return 100.0 * least / seconds
