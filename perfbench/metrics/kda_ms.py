"""kda_ms: a Kimi Linear pass's Kimi Delta Attention outside its 2:4
products, device ms a pass: the device time of the ``kda`` spans (the input
norm, the low-rank gate products, the short convolution, SiLU and L2 norms,
decay and beta, the gated output norm, the residual add) and of the
``kda_core`` spans inside them (the recurrence), over the traced passes.
The qkv and o products run in ``proj24`` spans of their own and are not
counted here. None where the trace saw no device time there."""

from perfbench.metrics._common import span_time


def read(run):
    total = 0.0
    for stage in ("kda", "kda_core"):
        got = span_time(run.traces[0], stage)
        if got is None:
            return None
        total += got[0]
    return 1e3 * total / run.trace_passes
