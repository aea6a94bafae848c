"""shared_expert_roofline: K3 on a MoE model's shared expert (the
``shared_expert`` spans: its gate_up and down products on every token,
its SwiGLU and the add into the residual stream): the least time of its
products over the spans' device time, in %. The least time is counted by
the route file (``shared_least_s``: each call's kept products at the bf16
peak or its bytes at HBM bandwidth, the larger). None where the trace saw
no device time there (a program with no shared-expert step)."""

from perfbench.metrics._common import span_time


def read(run):
    least = getattr(run.route, "shared_least_s", None)
    got = span_time(run.traces[0], "shared_expert")
    if least is None or got is None:
        return None
    seconds, _ = got
    return 100.0 * run.trace_passes * least(run.config, run.traffic) / seconds
