"""pipeline24_roofline: the whole prune -> compress -> pack -> matmul
pipeline (its ``prune_compress24``, ``pack_wg`` and ``spmm24`` spans)
against the pipeline's work whatever implements it: dense A read once,
B read once, C written once, and the kept products; in %."""

from perfbench import roofline
from perfbench.metrics._common import roofline_share

STAGES = ("prune_compress24", "pack_wg", "spmm24")


def bound(rows, n, k):
    return roofline.bound_s(roofline.kept_flops_24(rows, n, k),
                            roofline.pipeline24_bytes(rows, n, k))


def read(run):
    return roofline_share(run, STAGES, bound)
