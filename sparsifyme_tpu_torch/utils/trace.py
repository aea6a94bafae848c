"""The port's span recorder, on the profiler's clock, and its profiling
helpers.

Counterpart of ``sparsifyme_tpu.utils.trace``, which brackets code with
``jax.named_scope`` and captures with ``jax.profiler.trace``.

The recorder keeps spans of the ops dispatch in memory: each public call
(``spmm_24``, ``spmm_ell``, ``prune_compress_24``, ``pack_wg``,
``compress_24``, ``prune_nm``) records an entry span named
``sparsifyme.<entry>`` and, as its children, the phases that tile it
(``sparsifyme.<entry>.<phase>``: ``check_wg``, ``design``, ``prep``,
``plan``, ``alloc``, ``launch``, ...). It records only while someone
measures: while a ``torch.profiler`` session records, or inside
:func:`recording`. Otherwise a public call pays one flag check in
:func:`begin` and a falsy test in each :func:`mark`. The program opens no
``record_function`` or NVTX range of its own.

Stamps are ``time.time_ns()``: an event of the profiler's chrome trace
sits at ``ts`` µs + ``baseTimeNanoseconds`` / 1000 on that same wall clock,
so a span and a kernel of one session share one axis without an anchor
that could drift (:func:`chrome_events`, :func:`profile_trace`).

* :func:`begin` / :func:`mark` / :func:`end` — a public call's record: the
  entry opens it with its first phase, each mark closes the phase and
  opens the next, the end closes both.
* :func:`trace_range` — a span around a block (nested in the innermost
  open span); :func:`annotate` is its decorator form.
* :func:`count` — a counter, by one or by an amount (``plan_miss``: a
  cached plan computed anew; ``moe.rows``, ``moe.pad_rows``).
* :func:`recording` — record without the profiler.
* :func:`summary`, :func:`chrome_events`, :func:`reset` — read and clear.
* :func:`profile_trace` — a ``torch.profiler.profile`` over the CPU and,
  with a card, CUDA activity; writes its chrome trace with the session's
  spans merged in.
* :func:`busy_share` — the share of a captured window in which the device
  ran at least one kernel, copy or set.

Spans are kept for one dispatching thread: a span opened on another
thread while one is open nests under it.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import threading
import time
from collections import Counter
from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional, \
    Tuple

import torch
from torch.autograd import DeviceType
from torch.autograd import profiler as _profiler
from torch.profiler import ProfilerActivity, profile

TRACE_FILE = "trace.json"
CAPACITY = 1 << 20  # spans kept before later ones are dropped and counted
CATEGORY = "sparsifyme"  # the chrome-trace category of the program's spans

_now = time.time_ns


class Recorder:
    """Spans in a bounded buffer: ``spans[i]`` is ``(name id, start,
    parent, call, tid)`` and ``ends[i]`` its end (0 while open); times in
    ns of ``time.time_ns``, ``parent`` an index (-1 for none), ``call``
    the id shared by every span of one public call (0 outside any), and
    ``tid`` the thread's native id. Open spans are on ``stack`` as
    ``(index, call, tid, phases)``, ``phases`` the phase name ids of the
    call whose phase the span is (else None); a dropped span has index -1.
    A span takes about 200 bytes."""

    def __init__(self):
        self.capacity = CAPACITY
        self.stack: List[tuple] = []
        self.reset()

    def reset(self) -> None:
        self.names: List[str] = []
        self._ids: Dict[str, int] = {}
        # per entry name, its phases' name ids (None: the entry's own)
        self._phases: Dict[str, Dict[Optional[str], int]] = {}
        self._tids: Dict[int, int] = {}
        self.spans: List[Tuple[int, int, int, int, int]] = []
        self.ends: List[int] = []
        self.counters: Counter = Counter()
        self.dropped = 0
        self.calls = 0
        self.stack.clear()  # the same list: mark() holds it

    def _id(self, name: str) -> int:
        i = self._ids.get(name)
        if i is None:
            i = self._ids[name] = len(self.names)
            self.names.append(name)
        return i

    def _phase(self, phases: Dict[Optional[str], int], phase: str) -> int:
        i = phases.get(phase)
        if i is None:
            i = phases[phase] = self._id(
                self.names[phases[None]] + "." + phase)
        return i

    def _context(self) -> Tuple[int, int, int]:
        """``(parent, call, tid)`` of a span opened now."""
        if self.stack:
            return self.stack[-1][:3]
        ident = threading.get_ident()
        tid = self._tids.get(ident)
        if tid is None:
            tid = self._tids[ident] = threading.get_native_id()
        return -1, 0, tid

    def _push(self, name_id: int, now: int, parent: int, call: int,
              tid: int, phases) -> int:
        i = len(self.spans)
        if i < self.capacity:
            self.spans.append((name_id, now, parent, call, tid))
            self.ends.append(0)
        else:
            self.dropped += 1
            i = -1
        self.stack.append((i, call, tid, phases))
        return i

    def begin(self, name: str, phase: str) -> int:
        now = _now()
        token = len(self.stack) + 1
        parent, call, tid = self._context()
        if not call:
            self.calls += 1
            call = self.calls
        phases = self._phases.get(name)
        if phases is None:
            phases = self._phases[name] = {None: self._id(name)}
        i = self._push(phases[None], now, parent, call, tid, None)
        self._push(self._phase(phases, phase), now, i, call, tid, phases)
        return token

    def span(self, name: str) -> int:
        token = len(self.stack) + 1
        self._push(self._id(name), _now(), *self._context(), None)
        return token

    def mark(self, phase: str) -> None:
        """The hot path: close the open phase, open ``phase`` in its
        place (one stamp for both)."""
        stack = self.stack
        i, call, tid, phases = stack[-1]
        if phases is None:  # the innermost open span is not a phase
            return
        now = _now()
        name = phases.get(phase)
        if name is None:
            name = self._phase(phases, phase)
        if i >= 0:
            self.ends[i] = now
        j = len(self.spans)
        if j < self.capacity:
            self.spans.append((name, now, stack[-2][0], call, tid))
            self.ends.append(0)
        else:
            self.dropped += 1
            j = -1
        stack[-1] = (j, call, tid, phases)

    def close(self, token: int) -> None:
        now = _now()
        stack, ends = self.stack, self.ends
        while len(stack) >= token:
            i = stack.pop()[0]
            if i >= 0:
                ends[i] = now

    def summary(self) -> dict:
        ends = self.ends
        dur = [(e - sp[1]) if e else 0 for sp, e in zip(self.spans, ends)]
        covered = [0] * len(dur)
        for i, sp in enumerate(self.spans):
            if sp[2] >= 0:
                covered[sp[2]] += dur[i]
        spans: Dict[str, Dict[str, float]] = {}
        for i, sp in enumerate(self.spans):
            if not ends[i]:
                continue  # still open
            out = spans.setdefault(self.names[sp[0]],
                                   {"count": 0, "total_us": 0.0,
                                    "self_us": 0.0})
            out["count"] += 1
            out["total_us"] += dur[i] / 1e3
            out["self_us"] += (dur[i] - covered[i]) / 1e3
        return {"spans": spans, "counters": dict(self.counters),
                "calls": self.calls, "dropped": self.dropped}

    def chrome_events(self, base_ns: int, since_ns: int = 0) -> List[dict]:
        pid = os.getpid()
        out = []
        for i, (name, s, parent, call, tid) in enumerate(self.spans):
            e = self.ends[i]
            if not e or s < since_ns:
                continue
            out.append({"ph": "X", "cat": CATEGORY, "name": self.names[name],
                        "pid": pid, "tid": tid, "ts": (s - base_ns) / 1e3,
                        "dur": (e - s) / 1e3,
                        "args": {"span": i, "parent": parent,
                                 "call": call}})
        return out


_REC = Recorder()
_STACK = _REC.stack  # truthy while a span is open: mark()'s only test
_MARK = _REC.mark
_recording = 0  # depth of open recording() blocks


def begin(name: str, phase: str) -> Optional[int]:
    """Open a public call's record: its entry span ``name`` and first phase
    ``phase``. Returns a token for :func:`end`, or None (nothing recorded)
    when no one measures."""
    if _recording or _profiler._is_profiler_enabled:
        return _REC.begin(name, phase)
    return None


def mark(phase: str) -> None:
    """End the open call's current phase and start ``phase``; a no-op
    outside a recorded call."""
    if _STACK:
        _MARK(phase)


def end(token: int) -> None:
    """Close the call that :func:`begin` returned ``token`` for, with its
    open phase (and whatever was left open inside it)."""
    _REC.close(token)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` while someone measures."""
    if _recording or _profiler._is_profiler_enabled:
        _REC.counters[name] += n


class trace_range:
    """A span named ``name`` around a block, recorded while someone
    measures (a child of the innermost open span)."""

    __slots__ = ("name", "_token")

    def __init__(self, name: str):
        self.name = name
        self._token = None

    def __enter__(self) -> "trace_range":
        if _recording or _profiler._is_profiler_enabled:
            self._token = _REC.span(self.name)
        return self

    def __exit__(self, *exc: Any) -> bool:
        if self._token:
            _REC.close(self._token)
            self._token = None
        return False


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
def recording() -> Iterator[None]:
    """Record spans inside the block without a profiler session (and
    without its host cost)."""
    global _recording
    _recording += 1
    try:
        yield
    finally:
        _recording -= 1


def summary() -> dict:
    """Per span name its ``count``, ``total_us`` (host µs) and ``self_us``
    (the duration less the cover of its children), over the closed spans
    since the last :func:`reset`; with the ``counters``, the number of
    public ``calls`` recorded, and the spans ``dropped`` past the
    buffer's capacity."""
    return _REC.summary()


def chrome_events(base_ns: int, since_ns: int = 0) -> List[dict]:
    """The closed spans that started at or after ``since_ns`` as chrome
    ``"X"`` events on the axis of a profiler trace whose
    ``baseTimeNanoseconds`` is ``base_ns`` (category ``sparsifyme``; the
    span's index, its parent's and its call id in ``args``)."""
    return _REC.chrome_events(base_ns, since_ns)


def reset() -> None:
    """Drop every span and counter."""
    _REC.reset()


@contextlib.contextmanager
def profile_trace(log_dir: str) -> Iterator[profile]:
    """Profile the block and write its chrome trace to
    ``log_dir/trace.json`` (chrome://tracing or perfetto read it), with the
    program's spans of the session appended on the trace's own axis.
    Yields the profiler, whose events :func:`busy_share` reads after the
    block."""
    os.makedirs(log_dir, exist_ok=True)
    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    t0 = _now()
    with profile(activities=acts) as prof:
        yield prof
        if cuda:
            torch.cuda.synchronize()
    path = os.path.join(log_dir, TRACE_FILE)
    prof.export_chrome_trace(path)
    with open(path) as f:
        data = json.load(f)
    events = data["traceEvents"] if isinstance(data, dict) else data
    base = int(data.get("baseTimeNanoseconds", 0)) if isinstance(
        data, dict) else 0
    events.extend(chrome_events(base, since_ns=t0))
    with open(path, "w") as f:
        json.dump(data, f)


def union_length(intervals: Iterable[Tuple[float, float]]) -> float:
    """Total length covered by the union of ``(start, end)`` intervals."""
    total, end_ = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end_:
            continue
        total += e - max(s, end_)
        end_ = e
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
