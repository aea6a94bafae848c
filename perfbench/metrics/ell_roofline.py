"""ell_roofline: K4's calls (the ``ell`` spans) against the least time of
the same calls: kept blocks' values and column indices, B, C at HBM
bandwidth, or the kept blocks' products at the bf16 peak; in %."""

from perfbench import roofline
from perfbench.metrics._common import roofline_share


def read(run):
    ell = run.traffic["ell"]

    def bound(rows, n, k):
        bs, bk, kp, kept = roofline.ell_geometry(ell, k)
        return roofline.bound_s(
            roofline.ell_flops(rows, n, kept * bk),
            roofline.ell_bytes(rows, n, kp, kept * bk, bs, bk))

    return roofline_share(run, ("ell",), bound)
