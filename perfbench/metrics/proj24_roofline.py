"""proj24_roofline: K3 on a MoE model's 2:4 products outside the experts
(q, k, v and o of every layer, the dense layer's FFN: the ``proj24``
spans, which hold those calls alone): their least time over their device
time, in %. The least time is counted by the route file
(``proj24_least_s``: each call's kept products at the bf16 peak or its
bytes at HBM bandwidth, the larger). None where the trace saw no device
time there (a program whose blocks open no such span)."""

from perfbench.metrics._common import span_time


def read(run):
    least = getattr(run.route, "proj24_least_s", None)
    got = span_time(run.traces[0], "proj24")
    if least is None or got is None:
        return None
    seconds, _ = got
    return 100.0 * run.trace_passes * least(run.config, run.traffic) / seconds
