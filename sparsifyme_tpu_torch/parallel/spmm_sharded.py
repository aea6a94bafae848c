"""Sharded 2:4 SpMMs over a device mesh: batch and row partitioning, and the
ring exchange of B shards.

Counterpart of ``sparsifyme_tpu.parallel.spmm_sharded``, with the same
contracts and the same ``ValueError``s:

* :func:`spmm_24_batch_sharded` — the batch over ``axis``, B replicated, no
  communication; each rank runs kernel K3 on its batch shard.
* :func:`spmm_24_row_sharded` — A's (batch-folded) rows over ``axis``, B
  replicated, no communication.
* :func:`spmm_24_ring` — A's rows and B's contraction rows over ``axis``.
  Each of the P steps runs K3 (f32 out) on the k-slice of the local planes
  that matches the held B shard, while the shard is forwarded to the right
  neighbour: the ``lax.ppermute`` formulation, and the oracle of the kernel
  rings in :mod:`.ring_kernel`.

JAX maps the per-device function over the mesh with ``shard_map``. Here one
process plays every rank: the k-major planes ``[k4, M]`` are cut into P
contiguous column slabs on the ranks' devices (views where they already lie
there), each rank's work runs on its own CUDA streams, and C is gathered on
the device of the planes. Before a function returns, the caller's current
stream on every device involved waits for every rank's last event, so the
result is ready in stream order and CUDA events on that stream time the whole
call. On a 2-D mesh the functions run along ``axis`` at index 0 of the other
axes, which gives JAX's (replicated) result. CPU ranks run the same schedule
one step at a time with the plain versions.

On a process mesh (one rank per process, :mod:`.mesh`) each function runs
this rank's part of the ``shard_map`` body on its block (the process
contract): ``s`` is this rank's block of the planes
(:func:`shard_planes`), B is whole for the batch- and row-sharded
functions and this rank's k-shard of B (zero-padded to the planes' ``4 *
k4`` rows) for the ring, and the result is this rank's block of C, of
shape ``(*s.shape[:-1], n)``. The batch- and row-sharded functions run K3
on the block and communicate nothing. The ring's P steps each run K3 (f32
out) on the k-slice of the block that matches the held shard, while one
``dist.batch_isend_irecv`` pair sends the shard to ``(me+1) % P`` and
receives the one of ``(me-1) % P`` into a fresh buffer; the exchange is
issued on a comm stream of its own, so it overlaps the step's K3 on the
caller's stream, which waits for the shard before the next step. The comm
stream waits for the caller's stream before each exchange: the fresh buffer
is allocated on the caller's stream and may reuse the block of a shard that
the previous step's K3 still reads there.
"""

from __future__ import annotations

import contextlib
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..containers import Sparse24
from ..ops.sparse24 import spmm_24
from .mesh import Mesh, shard


class Rank:
    """One rank of a call: its device and, on a card, a compute stream and
    a comm stream of its own."""

    def __init__(self, device: torch.device):
        self.device = device
        cuda = device.type == "cuda"
        self.compute = torch.cuda.Stream(device) if cuda else None
        self.comm = torch.cuda.Stream(device) if cuda else None


def on(stream):
    """Make ``stream`` current on its device (nothing for a CPU rank)."""
    return (torch.cuda.stream(stream) if stream is not None
            else contextlib.nullcontext())


def record(stream) -> Optional[torch.cuda.Event]:
    """An event at the current end of ``stream`` (None for a CPU rank)."""
    if stream is None:
        return None
    ev = torch.cuda.Event()
    ev.record(stream)
    return ev


def wait(stream, *events) -> None:
    """Order the work queued on ``stream`` from now on after ``events``."""
    if stream is None:
        return
    for ev in events:
        if ev is not None:
            stream.wait_event(ev)


def send(src_rank: Rank, dst_rank: Rank, dst: torch.Tensor,
         src: torch.Tensor) -> None:
    """Copy ``src`` into ``dst`` on ``src_rank``'s comm stream. Across cards
    PyTorch also orders the copy after, and before, the destination
    device's current stream, made ``dst_rank``'s comm stream here."""
    other = dst_rank.comm if dst_rank.device != src_rank.device else None
    with on(src_rank.comm), on(other):
        dst.copy_(src, non_blocking=True)


class Ranks:
    """The ranks of one call. Creating it orders their streams after the
    work already queued on the callers' current streams (the inputs, and
    buffers allocated there); :meth:`end` orders those current streams after
    all of the ranks' work, so a buffer freed after the call is not reused
    while a rank still reads it. Create it after the inputs are placed on
    the ranks' devices, and keep every tensor the ranks use alive until
    :meth:`end` has run."""

    def __init__(self, devices: Sequence[torch.device],
                 others: Sequence[torch.device] = ()):
        self.ranks = [Rank(d) for d in devices]
        self._cards = list(dict.fromkeys(
            d for d in (*devices, *others) if d.type == "cuda"))
        starts = [record(torch.cuda.current_stream(d)) for d in self._cards]
        for rk in self.ranks:
            wait(rk.compute, *starts)
            wait(rk.comm, *starts)

    def end(self) -> None:
        evs = [record(s) for rk in self.ranks for s in (rk.compute, rk.comm)]
        for d in self._cards:
            wait(torch.cuda.current_stream(d), *evs)


def rows_of(s: Sparse24) -> int:
    *lead, m, _ = s.shape
    return int(np.prod(lead, dtype=np.int64)) * m


def plane_slabs(s: Sparse24, p: int, devices: Sequence[torch.device]):
    """Rank r's contiguous column slab ``[k4, M/p]`` of each plane, on its
    device: a view where the planes already lie there."""
    mloc = s.values0.shape[-1] // p
    return [tuple(x[:, r * mloc:(r + 1) * mloc].to(d)
                  for x in (s.values0, s.values1, s.codes))
            for r, d in enumerate(devices)]


def shard_planes(s: Sparse24, mesh: Mesh, axis: str) -> List[Sparse24]:
    """One :class:`Sparse24` per rank that this process plays (mesh
    order): the rank's block of ``s`` with its folded rows split over
    ``axis`` (planes ``[k4, M/P]``, spec ``(None, axis)``). A block of
    whole batch elements keeps the batch axis (``(bsz/P, ..., m, k)``),
    any other the folded form ``(M/P, k)``."""
    *lead, m, k = s.shape
    p = mesh.shape[axis]
    if s.values0.shape[-1] % p:
        raise ValueError(f"rows {s.values0.shape[-1]} not divisible by axis "
                         f"size {p}")
    mloc = s.values0.shape[-1] // p
    if lead and lead[0] % p == 0:
        shape = (lead[0] // p, *lead[1:], m, k)
    else:
        shape = (mloc, k)
    planes = [shard(x, (None, axis), mesh)
              for x in (s.values0, s.values1, s.codes)]
    return [Sparse24(v0, v1, codes, shape=shape)
            for v0, v1, codes in zip(*planes)]


def pad_rows(b: torch.Tensor, rows: int) -> torch.Tensor:
    return F.pad(b, (0, 0, 0, rows - b.shape[0])) if b.shape[0] < rows else b


def _shard_rows(s: Sparse24, b: torch.Tensor, devices: List[torch.device],
                local) -> torch.Tensor:
    """``shard_map`` over the planes' columns with B replicated:
    ``local(v0, v1, codes, b)`` runs on each rank's compute stream and its
    ``[M/P, n]`` result lands in C ``[M, n]`` on the planes' device."""
    p = len(devices)
    home = s.values0.device
    rows, n = s.values0.shape[-1], b.shape[-1]
    mloc = rows // p
    slabs = plane_slabs(s, p, devices)
    bs = [b.to(d) for d in devices]
    out = torch.empty((rows, n), dtype=torch.promote_types(s.dtype, b.dtype),
                      device=home)
    ranks = Ranks(devices, (home, b.device))
    for r, rk in enumerate(ranks.ranks):
        with on(rk.compute):
            out[r * mloc:(r + 1) * mloc].copy_(local(*slabs[r], bs[r]),
                                               non_blocking=True)
    ranks.end()
    return out


def spmm_24_batch_sharded(s: Sparse24, b: torch.Tensor, mesh: Mesh,
                          axis: str = "data") -> torch.Tensor:
    """Batched 2:4 SpMM with the batch dim sharded over ``axis``.

    ``s`` must have a leading batch dim divisible by the axis size. B is
    replicated; no communication (the DP analog of per-batch streams).
    """
    if len(s.shape) < 3:
        raise ValueError("batch-sharded spmm needs a leading batch dim")
    if mesh.is_process_mesh:
        mesh.check("spmm_24_batch_sharded", s.values0, b)
        return spmm_24(s, b)
    *lead, m, k = s.shape
    bsz = int(np.prod(lead))
    p = mesh.shape[axis]
    if bsz % p:
        raise ValueError(f"batch {bsz} not divisible by axis size {p}")

    def local(v0, v1, codes, bmat):
        # A column slab of (bsz/P)*m is bsz/P whole batch elements.
        s_local = Sparse24(v0, v1, codes, shape=(bsz // p, m, k))
        return spmm_24(s_local, bmat).reshape(-1, bmat.shape[-1])

    out = _shard_rows(s, b, mesh.axis_devices(axis), local)
    return out.reshape(*lead, m, b.shape[-1])


def spmm_24_row_sharded(s: Sparse24, b: torch.Tensor, mesh: Mesh,
                        axis: str = "model") -> torch.Tensor:
    """2:4 SpMM with A's (batch-folded) rows sharded over ``axis``, B
    replicated. The planes are k-major ``[k4, M]``, so the row shard is a
    column slab of them; the output ``(..., m, n)`` gathers the slabs."""
    if mesh.is_process_mesh:
        mesh.check("spmm_24_row_sharded", s.values0, b)
        return spmm_24(s, b)
    *lead, m, k = s.shape
    p = mesh.shape[axis]
    if s.values0.shape[-1] % p:
        raise ValueError(f"rows {s.values0.shape[-1]} not divisible by axis "
                         f"size {p}")

    def local(v0, v1, codes, bmat):
        return spmm_24(Sparse24(v0, v1, codes, shape=(v0.shape[-1], k)),
                       bmat)

    out = _shard_rows(s, b, mesh.axis_devices(axis), local)
    return out.reshape(*lead, m, b.shape[-1])


def check_ring(s: Sparse24, mesh: Mesh, axis: str) -> int:
    """The ring's divisibility contract; returns P."""
    p = mesh.shape[axis]
    m_total = rows_of(s)
    if m_total % p:
        raise ValueError(
            f"folded rows {m_total} not divisible by axis size {p}")
    k4 = s.values0.shape[-2]
    if k4 % p:
        raise ValueError(f"k4 {k4} not divisible by axis size {p}")
    return p


def spmm_24_ring(s: Sparse24, b: torch.Tensor, mesh: Mesh,
                 axis: str = "model", out_dtype=None) -> torch.Tensor:
    """Row-partitioned 2:4 SpMM with B k-sharded and a ring exchange.

    A (compressed) is sharded over rows along ``axis`` and B over its
    contraction rows along the same axis. Each of the P steps multiplies
    the local k-slice that matches the held B shard (K3, f32 out) while the
    shard is forwarded to the right neighbour on the comm stream, into a
    fresh buffer, as ``lax.ppermute`` returns a new array. Batched A folds
    into rows (batch-major), so the row partition shards whole batch
    elements and the output unfolds for free. B is zero-padded to the
    planes' ``4 * k4`` rows.

    Requires: prod(batch)*m % P == 0 and k4 % P == 0. On a process mesh
    ``s`` and B are this rank's blocks (the module docstring).
    """
    if mesh.is_process_mesh:
        return _ring_processes(s, b, mesh, axis, out_dtype)
    *lead, m, _ = s.shape
    p = check_ring(s, mesh, axis)
    k4s = s.values0.shape[-2] // p
    n = b.shape[-1]
    out_dtype = out_dtype or torch.promote_types(s.dtype, b.dtype)
    devices = mesh.axis_devices(axis)
    home = s.values0.device
    m_total = rows_of(s)
    mloc = m_total // p
    bp = pad_rows(b, 4 * k4s * p)
    slabs = plane_slabs(s, p, devices)
    # held[r][i]: the shard rank r holds at step i (that of rank (r-i) % P)
    held = [[bp[r * 4 * k4s:(r + 1) * 4 * k4s].to(d)]
            + [torch.empty((4 * k4s, n), dtype=b.dtype, device=d)
               for _ in range(p - 1)] for r, d in enumerate(devices)]
    out = torch.empty((m_total, n), dtype=out_dtype, device=home)
    ranks = Ranks(devices, (home, b.device))
    rk_ = ranks.ranks
    arrived = {}
    accs: List[Optional[torch.Tensor]] = [None] * p
    for i in range(p):
        for r, rk in enumerate(rk_):
            right = (r + 1) % p
            if i + 1 < p:
                wait(rk.comm, arrived.get((r, i)))
                send(rk, rk_[right], held[right][i + 1], held[r][i])
                arrived[right, i + 1] = record(rk.comm)
            wait(rk.compute, arrived.get((r, i)))
            src = (r - i) % p
            g = slice(src * k4s, (src + 1) * k4s)
            v0, v1, codes = slabs[r]
            with on(rk.compute):
                part = spmm_24(Sparse24(v0[g], v1[g], codes[g],
                                        shape=(mloc, 4 * k4s)),
                               held[r][i], out_dtype=torch.float32)
                accs[r] = part if i == 0 else accs[r].add_(part)
    for r, rk in enumerate(rk_):
        with on(rk.compute):
            out[r * mloc:(r + 1) * mloc].copy_(accs[r], non_blocking=True)
    ranks.end()
    return out.reshape(*lead, m, n)


def check_shard(s: Sparse24, b: torch.Tensor, p: int) -> int:
    """A process ring's contract on this rank's blocks; returns ``k4 / P``.
    """
    k4 = s.values0.shape[-2]
    if k4 % p:
        raise ValueError(f"k4 {k4} not divisible by axis size {p}")
    k4s = k4 // p
    if b.shape[0] != 4 * k4s:
        raise ValueError(
            f"B's shard has {b.shape[0]} rows, not 4 * k4 / P = {4 * k4s}: "
            f"pad B to the planes' {4 * k4} rows before sharding it")
    return k4s


def p2p_exchange(send_buf: torch.Tensor, recv_buf: torch.Tensor,
                 mesh: Mesh, axis: str):
    """Send ``send_buf`` to the right neighbour on ``axis`` and receive
    the left one's into ``recv_buf``, both in one ``batch_isend_irecv``
    group (every rank posts both, so none blocks on the other); returns
    the works. NCCL orders the exchange after the current stream."""
    import torch.distributed as dist

    left, right = mesh.ring_peers(axis)
    group = mesh.group(axis)
    return dist.batch_isend_irecv([
        dist.P2POp(dist.isend, send_buf, right, group),
        dist.P2POp(dist.irecv, recv_buf, left, group)])


def finish(stream, works) -> Optional[torch.cuda.Event]:
    """Order ``stream`` after ``works`` (a CPU rank waits for them) and
    return an event at its end."""
    with on(stream):
        for w in works:
            w.wait()
    return record(stream)


def _ring_processes(s: Sparse24, b: torch.Tensor, mesh: Mesh, axis: str,
                    out_dtype) -> torch.Tensor:
    """:func:`spmm_24_ring`'s body on this rank's blocks."""
    mesh.check("spmm_24_ring", s.values0, b)
    p = mesh.shape[axis]
    k4s = check_shard(s, b, p)
    me = mesh.axis_index(axis)
    n, mloc = b.shape[-1], s.values0.shape[-1]
    out_dtype = out_dtype or torch.promote_types(s.dtype, b.dtype)
    dev = s.values0.device
    main = torch.cuda.current_stream(dev) if dev.type == "cuda" else None
    comm = Rank(dev).comm
    cur = b.contiguous()
    acc = None
    for i in range(p):
        works = []
        if i + 1 < p:
            nxt = torch.empty_like(cur)  # as lax.ppermute: a new array
            # nxt may be the block of a shard that the last step's K3 still
            # reads on main: the receive into it waits for main.
            wait(comm, record(main))
            with on(comm):
                works = p2p_exchange(cur, nxt, mesh, axis)
        src = (me - i) % p
        g = slice(src * k4s, (src + 1) * k4s)
        part = spmm_24(Sparse24(s.values0[g], s.values1[g], s.codes[g],
                                shape=(mloc, 4 * k4s)),
                       cur, out_dtype=torch.float32)
        acc = part if acc is None else acc.add_(part)
        if works:
            ready = finish(comm, works)
            wait(main, ready)
            cur = nxt
    return acc.to(out_dtype).reshape(*s.shape[:-1], n)
