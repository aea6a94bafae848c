"""mlp24_mfu: the example MLP's pass against one card's bf16 peak: the
products its 2:4 weights keep, counted by its route file
(``Mlp24.kept_flops``), over the window's time a pass, in %."""

from perfbench import roofline


def read(run):
    if not run.pass_ms > 0:
        return None
    flops = run.route.kept_flops(run.config, run.traffic)
    return 100.0 * flops / (run.pass_ms * 1e-3 * roofline.PEAK_BF16_FLOPS)
