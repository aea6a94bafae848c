"""mimo_mfu: a MiMo-V2-Flash prefill against one card's bf16 peak: the
model's work a pass, counted by its route file (``Mimo24.pass_flops``:
the kept 2:4 products, the dense router, the causal and windowed
attention core, the last positions' head) over the window's time a pass,
in %."""

from perfbench import roofline


def read(run):
    flops = getattr(run.route, "pass_flops", None)
    if flops is None or not run.pass_ms > 0:
        return None
    return 100.0 * flops(run.config, run.traffic) / (
        run.pass_ms * 1e-3 * roofline.PEAK_BF16_FLOPS)
