"""idle_share: the share of the traced window in which the card ran
nothing, 1 - (union of the card's activity) / (traced window), in %,
averaged over the cards. The profiler's own cost lengthens a traced pass
on the host, so a host-bound cell reads idler here than in its untraced
window."""


def read(run):
    traces = [t for t in run.traces if t and t["window_s"] > 0]
    if len(traces) != len(run.traces) or \
            not all(t["busy_s"] > 0 for t in traces):
        return None
    return 100.0 * sum(1.0 - t["busy_s"] / t["window_s"]
                       for t in traces) / len(traces)
