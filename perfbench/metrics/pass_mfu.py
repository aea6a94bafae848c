"""pass_mfu: the whole pass's share of one card's bf16 peak: the products
that the sparse format keeps on a card, over the window's time a pass,
in % of 989 TFLOP/s."""

from perfbench import roofline


def read(run):
    if not run.pass_ms > 0:
        return None
    flops = roofline.pass_kept_flops(run.traffic, run.layers)
    return 100.0 * flops / (run.pass_ms * 1e-3 * roofline.PEAK_BF16_FLOPS)
