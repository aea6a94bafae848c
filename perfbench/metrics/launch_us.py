"""launch_us: host µs a launch, from the program's own spans: the total
duration of the ``launch`` phase of the entries that ``dispatch_us``
reads (the loaded entry point's lookup, the C call that queues the
kernel, its status check) over its count. None where no call launched
(the plain versions on the CPU), on several ranks, or where the program
records no such span."""

from perfbench.metrics.dispatch_us import (ENTRIES, PREFIX, mean_us,
                                           program_spans)


def read(run):
    spans = program_spans(run)
    if spans is None:
        return None
    return mean_us(spans, [PREFIX + e + ".launch" for e in ENTRIES])
