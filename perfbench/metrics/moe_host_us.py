"""moe_host_us: host µs a MoE layer of the program, from its own spans:
the ``sparsifyme.moe`` record (routing, the group sizes' copy to the host,
every held expert's two products, the combine) over its count, in the
traced passes. None where the program records no such span."""

from perfbench.metrics.dispatch_us import PREFIX, mean_us, program_spans


def read(run):
    spans = program_spans(run)
    if spans is None:
        return None
    return mean_us(spans, [PREFIX + "moe"])
