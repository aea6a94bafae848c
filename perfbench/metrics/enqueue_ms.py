"""enqueue_ms: the host's time to queue a pass, from its first call into
the program to its last call's return and before the sync, as the mean
over the window's passes (on several ranks, the largest rank's)."""


def read(run):
    return max(run.enqueue_ms) if run.enqueue_ms else None
