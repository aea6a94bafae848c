"""spmm24_roofline: K3's calls (the ``spmm24`` spans): the least time of
the same calls over their device time, in %. A call's least time is the
larger of its kept products at the bf16 peak and its bytes (A at the 2:4
format's 1.125 B a logical element, B, C) at HBM bandwidth."""

from perfbench import roofline
from perfbench.metrics._common import roofline_share


def bound(rows, n, k):
    return roofline.bound_s(roofline.kept_flops_24(rows, n, k),
                            roofline.spmm24_bytes(rows, n, k))


def read(run):
    return roofline_share(run, ("spmm24",), bound)
