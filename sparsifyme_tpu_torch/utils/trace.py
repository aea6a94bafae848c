"""Tracing and profiling annotations: named ranges, a chrome-trace capture
and the device's busy share of a captured window.

Counterpart of ``sparsifyme_tpu.utils.trace``, which brackets code with
``jax.named_scope`` and captures with ``jax.profiler.trace`` (the reference
uses NVTX ranges and torch.profiler's chrome traces).

* :func:`trace_range` — a ``torch.profiler.record_function`` range, which
  the profiler's timeline shows, and an NVTX range where a card is present
  (the CPU build of PyTorch has no NVTX).
* :func:`annotate` — decorator form of :func:`trace_range`.
* :func:`profile_trace` — a ``torch.profiler.profile`` over the CPU and,
  with a card, CUDA activity; writes a chrome trace into a directory.
* :func:`busy_share` — the share of a captured window in which the device
  ran at least one kernel, copy or set.
"""

from __future__ import annotations

import contextlib
import functools
import os
from typing import Any, Callable, Iterable, Iterator, Optional, Tuple

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace_range(name: str) -> Iterator[None]:
    """Named range visible in the profiler's timeline (and, with a card, in
    NVTX-reading tools)."""
    nvtx = torch.cuda.is_available()
    with record_function(name):
        if nvtx:
            torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            if nvtx:
                torch.cuda.nvtx.range_pop()


def annotate(name: Optional[str] = None):
    """Decorator: run the function body inside :func:`trace_range`, named
    ``name`` or the function's ``__qualname__``."""

    def deco(fn: Callable[..., Any]) -> Callable[..., Any]:
        scope = name or fn.__qualname__

        @functools.wraps(fn)
        def wrapper(*args: Any, **kwargs: Any) -> Any:
            with trace_range(scope):
                return fn(*args, **kwargs)

        return wrapper

    return deco


@contextlib.contextmanager
def profile_trace(log_dir: str) -> Iterator[profile]:
    """Profile the block and write its chrome trace to
    ``log_dir/trace.json`` (chrome://tracing or perfetto read it). Yields
    the profiler, whose events :func:`busy_share` reads after the block."""
    os.makedirs(log_dir, exist_ok=True)
    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        yield prof
        if cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


def union_length(intervals: Iterable[Tuple[float, float]]) -> float:
    """Total length covered by the union of ``(start, end)`` intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def busy_share(prof) -> float:
    """Share of the traced window in which the device was busy: the union
    of the intervals of the device's events (kernels, copies, sets) over
    the span from the first event of the trace, on the host or the device,
    to the last. 0.0 for an empty trace."""
    events = list(prof.events())
    if not events:
        return 0.0
    t0 = min(e.time_range.start for e in events)
    t1 = max(e.time_range.end for e in events)
    if t1 <= t0:
        return 0.0
    busy = union_length((e.time_range.start, e.time_range.end)
                        for e in events if e.device_type == DeviceType.CUDA)
    return busy / (t1 - t0)
