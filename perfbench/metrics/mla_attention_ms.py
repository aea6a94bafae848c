"""mla_attention_ms: a DeepSeek-V3 pass's multi-head latent attention
outside its 2:4 products, device ms a pass: the device time of the
``attention`` spans (the input and latent norms, YaRN RoPE, the k and q
assembly, the attention core, the residual add), whose q_a, kv_a, q_b,
kv_b and o products run in ``proj24`` spans of their own and so are not
counted here, over the traced passes. None where the trace saw no device
time there."""

from perfbench.metrics._common import span_time


def read(run):
    got = span_time(run.traces[0], "attention")
    if got is None:
        return None
    return 1e3 * got[0] / run.trace_passes
