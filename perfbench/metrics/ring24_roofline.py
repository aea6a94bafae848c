"""ring24_roofline: K7's device time in the ring's spans (the program's
kernels there; the exchange's NCCL kernels and the copies left out)
against a rank's least time: its A at the 2:4 format's 1.125 B a logical
element, every B shard and its C rows at HBM bandwidth, or its kept
products at the bf16 peak; over every rank, in %."""

from perfbench import roofline
from perfbench.metrics._common import roofline_share


def bound(rows, n, k):
    return roofline.bound_s(roofline.kept_flops_24(rows, n, k),
                            roofline.ring24_bytes(rows, n, k))


def read(run):
    return roofline_share(run, ("ring24",), bound, kind="compute")
