"""Capture of a whole K7 ring as one CUDA graph, and its replay.

Queueing a ring costs the host far more than the card spends on it: per
rank and step, checks, a ctypes launch, stream and device switches and a
few CUDA events (at 25088 x 256 x 1024 on four ranks, the host needed
2.6 ms to queue what K7 ran in 0.28 ms). :func:`run` queues the ring
eagerly the first time it sees a key, captures it under
``torch.cuda.graph`` the second time, and replays the graph from then on:
staging copies, sends on the comm streams, every K7 launch on the compute
streams, the events that order them (the rank streams fork from the
capturing stream and rejoin it, as :class:`~.spmm_sharded.Ranks` does
around every call) and the copy of C to its home device. The schedule is
the same; only its queueing is recorded.

Why not capture at first sight: a capture costs several eager rings
(``torch.cuda.graph`` synchronises the card, collects garbage and empties
the allocator's cache before it records), and a caller whose operands are
new on every call (an activation B at a fresh address) would pay it on
every call and never replay. Such a caller pays the eager ring only, as a
ring that never captures does; the key of a first sight is kept in a
bounded list of :data:`SEEN_SIZE` keys.

Which meshes replay: those whose ranks, planes and B all lie on one card
(:func:`captures`). A mesh over several cards, and CPU ranks, queue the
ring eagerly on every call. The choice is made from the devices, never by
catching a failed capture.

The key (:func:`graph_key`) holds the address, shape, stride, dtype and
device of ``v0``, ``v1``, ``codes`` and B, the logical shape, the output
type, the route and its m-tile, the mesh's devices, the step function in
use (a ring run with another step, such as the plain one, captures its
own graph), K7's step design and, on the ``wgmma_sp`` design, the packed
operand the steps read (a graph captured on one design or operand never
replays for another). A replay reads whatever the operands' memory holds
at that time, so a tensor updated in place gives the new product.

Each entry holds its graph's private memory pool: the ranks' comm slots,
f32 accumulators and C, about 45 MB at 25088 x 256 x 1024 on four ranks.
The cache is an LRU of :data:`CACHE_SIZE` entries, more than the six
operand replicas ``utils.timing`` cycles through (it warms each replica
twice, so its timed calls all replay). C is copied out of the pool on the
caller's stream after each replay, so a result survives the next call.

Launch counters: a step wrapper counts when it runs, which for a graph is
at capture only. The capture takes back what it added, and every replay
adds the graph's launch count to the counters, one per wrapper (so per
design: each design's steps have wrappers of their own).
"""

from __future__ import annotations

import collections
from typing import Callable, Dict, Optional, Sequence

import torch

CACHE_SIZE = 16
SEEN_SIZE = 64

_cache: "collections.OrderedDict[tuple, _Entry]" = collections.OrderedDict()
_seen: "collections.OrderedDict[tuple, None]" = collections.OrderedDict()


class _Entry:
    def __init__(self, graph: torch.cuda.CUDAGraph, out: torch.Tensor,
                 launches: Dict[Callable, int], device: torch.device):
        self.graph = graph
        self.out = out
        self.launches = launches
        self.device = device

    def replay(self) -> torch.Tensor:
        """Replay on the current stream; C copied out of the pool."""
        with torch.cuda.device(self.device):
            self.graph.replay()
            out = self.out.clone()
        for fn, n in self.launches.items():
            fn.launches += n
        return out


def _card(d: torch.device) -> int:
    return d.index if d.index is not None else torch.cuda.current_device()


def captures(devices: Sequence[torch.device], *tensors: torch.Tensor) -> bool:
    """True when every rank and every operand lies on one CUDA card: the
    meshes whose rings are captured and replayed."""
    devs = list(devices) + [t.device for t in tensors]
    if any(d.type != "cuda" for d in devs):
        return False
    return len({_card(d) for d in devs}) == 1


def _tensor_key(t: torch.Tensor) -> tuple:
    return (t.data_ptr(), tuple(t.shape), t.stride(), t.dtype, t.device)


def graph_key(v0: torch.Tensor, v1: torch.Tensor, codes: torch.Tensor,
              b: torch.Tensor, *, shape: tuple, out_dtype, route: str,
              m_tile: int, devices: Sequence[torch.device],
              step: Callable, design: str = "mma_sp",
              wg: Optional[torch.Tensor] = None) -> tuple:
    """The cache key of one ring call (see the module docstring)."""
    return (tuple(_tensor_key(t) for t in (v0, v1, codes, b)), tuple(shape),
            out_dtype, route, m_tile, tuple(devices), step, design,
            None if wg is None else _tensor_key(wg))


def clear() -> None:
    """Drop every captured ring (and its memory pool) and every key seen."""
    _cache.clear()
    _seen.clear()


def _capture(queue: Callable[[], torch.Tensor], device: torch.device,
             counters: Sequence[Callable]) -> _Entry:
    before = {fn: fn.launches for fn in counters}
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.device(device):
        with torch.cuda.graph(graph, stream=torch.cuda.Stream(device)):
            out = queue()
    launches = {}
    for fn in counters:
        launches[fn] = fn.launches - before[fn]
        fn.launches = before[fn]
    return _Entry(graph, out, launches, device)


def run(key: tuple, queue: Callable[[], torch.Tensor], device: torch.device,
        counters: Sequence[Callable]) -> torch.Tensor:
    """The ring of ``key``: ``queue()`` queues it and returns C. The first
    call with a key runs the ring eagerly; the second captures ``queue()``
    into a graph; that call and every later one replay the graph on the
    current stream. ``counters`` are the step wrappers whose ``launches``
    the graph accounts for."""
    entry = _cache.get(key)
    if entry is None:
        if key not in _seen:
            _seen[key] = None
            while len(_seen) > SEEN_SIZE:
                _seen.popitem(last=False)
            return queue()
        del _seen[key]
        entry = _cache[key] = _capture(queue, device, counters)
        while len(_cache) > CACHE_SIZE:
            _cache.popitem(last=False)
    _cache.move_to_end(key)
    return entry.replay()
