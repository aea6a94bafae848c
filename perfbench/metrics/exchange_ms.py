"""exchange_ms: the exchange's NCCL device time in the ring's spans a
pass, per rank, the largest rank's. An NCCL kernel's time includes its
wait for a peer that its host has not yet reached."""

from perfbench.metrics._common import span_time


def read(run):
    per_rank = []
    for trace in run.traces:
        got = span_time(trace, "ring24", "nccl")
        if got is None:
            return None
        seconds, count = got
        per_rank.append(seconds * 1e3 / (count / len(run.layers)))
    return max(per_rank)
