"""dispatch_us: host µs a public call of the program, from the program's
own spans (``sparsifyme_tpu_torch.utils.trace``): the total duration of
its entry spans (``spmm_24``, ``spmm_ell``, ``prune_compress_24``,
``pack_wg``) over their count. The recorder records while the profiler
does, so in a one-card cell it holds exactly the traced passes, read here
in the benchmark's own process; like ``idle_share`` it reads the host
under the profiler. None on several ranks, or where the program records
no such span."""

ENTRIES = ("spmm_24", "spmm_ell", "prune_compress_24", "pack_wg")
PREFIX = "sparsifyme."


def program_spans(run):
    """The recorder's spans by name, or None (several ranks, or a program
    without the recorder)."""
    if run.world > 1:
        return None
    try:
        from sparsifyme_tpu_torch.utils import trace
    except ImportError:
        return None
    summary = getattr(trace, "summary", None)
    return summary()["spans"] if summary is not None else None


def mean_us(spans, names):
    got = [spans[n] for n in names if n in spans and spans[n]["count"]]
    if not got:
        return None
    return sum(s["total_us"] for s in got) / sum(s["count"] for s in got)


def read(run):
    spans = program_spans(run)
    if spans is None:
        return None
    return mean_us(spans, [PREFIX + e for e in ENTRIES])
