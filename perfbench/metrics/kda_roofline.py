"""kda_roofline: the KDA recurrence (the ``kda_core`` spans of a Kimi
Linear model's traced passes): its least time over its device time, in %.
The least time is counted by the route file (``kda_least_s``: the larger
of the recurrence's bytes, q, k, v, the decay's input and o at 2 B an
element and beta, at HBM bandwidth, and its work, ``4 d^2 + 2 C (2 d)``
FLOP a head-token, at the bf16 peak) over the tokens x heads that the
program's counter ``kda.tokens`` saw, scaled to the traced window as
``expert_roofline`` scales ``moe.rows``. The work is fixed by the block's
inputs and outputs, so the share reads the same for any kernel that
computes it. None where the program has no such counter or span, or the
trace saw no device time there."""

from perfbench.metrics._common import span_time
from perfbench.metrics.dispatch_us import PREFIX, program_spans
from perfbench.metrics.expert_roofline import program_counters


def read(run):
    spans = program_spans(run)
    tokens = program_counters().get("kda.tokens")
    calls = (spans or {}).get(PREFIX + "kda", {}).get("count")
    got = span_time(run.traces[0], "kda_core")
    least = getattr(run.route, "kda_least_s", None)
    if not tokens or not calls or got is None or least is None:
        return None
    seconds, layers = got  # one kda_core span a KDA layer
    tokens = tokens / calls * layers  # the traced window's head-tokens
    return 100.0 * least(run.config, tokens) / seconds
