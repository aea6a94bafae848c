"""Ring 2:4 SpMM with an explicit, overlapped exchange of B shards: kernel K7.

Counterpart of ``sparsifyme_tpu.parallel.ring_kernel``.
:func:`spmm_24_ring_explicit` replaces ``spmm_24_ring_pallas`` (B10) and
:func:`spmm_24_ring_tiled` replaces ``spmm_24_ring_tiled_pallas`` (B11). On
the TPU one Pallas kernel runs a rank's whole ring: it starts the remote
copy of the held shard into the right neighbour's other comm slot, contracts
the matching k-slice on the matrix unit meanwhile, and orders the two with
DMA semaphores and capacity credits. On Hopper a copy between cards leaves
the kernel, so the port splits the two halves:

* the exchange follows ``_ring_kernel`` step by step on the host: two comm
  slots per rank; the local shard staged into slot 0 on the rank's comm
  stream (an event in place of the Pallas barrier); at step i the slot is
  copied into the right neighbour's other slot on the comm stream, after
  the neighbour's "slot free" event of step i-1 (the capacity credit);
* the contraction of step i is kernel K7 (``csrc/ring24.cu``) on the
  rank's compute stream, after the event that the step's slot arrived;
  then the rank's "slot free" event is recorded. It also waits for the
  rank's own outgoing copy of that slot: a copy engine reads it too.

Work is queued step-major, then rank-minor, so every event is recorded
before any stream waits on it (CUDA treats a wait on an event not yet
recorded as satisfied: a silent race). The tiled route runs the ring once
per m-tile of ``m_tile`` columns, re-staging slot 0 and re-sending the
shard for each tile (comm volume times the tile count, as on the TPU), with
the cross-tile credit of ``_ring_kernel_tiled`` (``last_odd``) and its own
launch counter, ``ring_step_tiled_cuda.launches``.

K7 places each kept value at its own k (as K3 does), so B is taken
unpermuted; :func:`ring_permute_b` is kept with its contract for callers of
the Pallas layout. C accumulates in an f32 buffer per rank and the last step
writes C in ``out_dtype``.

On a mesh whose ranks and operands share one card, a ring is replayed as a
CUDA graph (:mod:`.ring_graph`) once it has been called twice with the same
operands, mesh, route and step function: the first call runs eagerly, the
second captures and replays. Meshes over several cards queue every call
eagerly.
Ranks on CPU devices run the same schedule in order with the plain version
of K7, and never capture.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import _build
from ..containers import Sparse24
from ..ops.kernels.prune_kernel import DTYPE_CODES
from ..ops.kernels.spmm24_kernel import card_tile, expand_planes
from . import ring_graph
from .mesh import Mesh
from .spmm_sharded import (Ranks, on, pad_rows, plane_slabs, record,
                           rows_of, send, wait)


def ring_permute_b(b: torch.Tensor, p: int) -> torch.Tensor:
    """Pre-permute B's rows quarter-major *within each 1/p shard* (row
    ``4g+q`` of a shard moves to ``q*k4_shard+g``): the layout the Pallas
    ring contracts. K7 does not need it."""
    k, n = b.shape
    if k % (4 * p):
        raise ValueError(f"k {k} not divisible by 4*P {4 * p}")
    k4s = k // (4 * p)
    return b.reshape(p, k4s, 4, n).transpose(1, 2).reshape(k, n)


def _pick_mt(mloc: int, cap: int = 2048) -> int:
    """Largest 128-multiple divisor of ``mloc`` under ``cap``; falls back to
    ``mloc`` whole."""
    for mt in range(min(cap, mloc) - min(cap, mloc) % 128, 127, -128):
        if mloc % mt == 0:
            return mt
    return mloc


def ring_step_plain(v0, v1, codes, slot, acc, out, *, src: int, c0: int,
                    mt: int, first: bool, last: bool) -> None:
    """Plain version of K7 on one rank's planes ``[k4, mloc]``: with ``k4s =
    slot.shape[0] // 4`` and columns ``c0 .. c0+mt``, ``part =
    expand(planes)[src*k4s : (src+1)*k4s, cols]^T @ slot`` in f32; ``acc[cols]
    = part`` (``first``) or ``+= part``; on ``last``, ``out[cols] = acc[cols]
    + part`` (or ``part`` when also ``first``) in ``out``'s type, and ``acc``
    is left alone."""
    k4s = slot.shape[0] // 4
    g, cs = slice(src * k4s, (src + 1) * k4s), slice(c0, c0 + mt)
    a_t = expand_planes(v0[g, cs], v1[g, cs], codes[g, cs])
    part = a_t.to(torch.float32).T @ slot.to(torch.float32)
    if not first:
        part = part + acc[cs]
    (out if last else acc)[cs] = part


def plane_window(v0: torch.Tensor, src: int, k4s: int, c0: int) -> int:
    """Element offset of plane element ``(src*k4s, c0)`` from ``v0``'s first
    element, for planes with rows ``v0.stride(0)`` elements apart: where K7
    reads its window."""
    return src * k4s * v0.stride(0) + c0


def _launch(v0, v1, codes, slot, acc, out, *, src, c0, mt, first, last,
            what) -> None:
    if not (v0.is_cuda and slot.is_cuda and out.is_cuda):
        raise ValueError(f"{what} needs CUDA tensors")
    dev = v0.device
    tensors = [v1, codes, slot, out] + ([] if acc is None else [acc])
    if any(t.device != dev for t in tensors):
        raise ValueError(f"{what}: operands on more than one device")
    if slot.dtype != v0.dtype or v1.dtype != v0.dtype:
        raise TypeError(f"{what}: planes and slot must share a type")
    if v0.dtype not in DTYPE_CODES or out.dtype not in DTYPE_CODES:
        raise TypeError(f"{what} takes float32/bfloat16, not {v0.dtype} -> "
                        f"{out.dtype}")
    if codes.dtype != torch.uint8:
        raise TypeError(f"{what}: codes must be uint8")
    k4, mloc = v0.shape
    if v1.shape != v0.shape or codes.shape != v0.shape:
        raise ValueError(f"{what}: planes must share a shape")
    if any(t.stride(1) != 1 or t.stride(0) != v0.stride(0)
           for t in (v0, v1, codes)):
        raise ValueError(f"{what}: planes need unit column stride and one "
                         f"row stride")
    rows, n = slot.shape
    k4s = rows // 4
    if rows % 4 or not slot.is_contiguous():
        raise ValueError(f"{what}: slot must be a contiguous [4*k4s, n]")
    if not (0 <= src and (src + 1) * k4s <= k4 and 0 <= c0
            and 0 < mt and c0 + mt <= mloc):
        raise ValueError(f"{what}: window (src {src}, columns {c0}+{mt}) "
                         f"outside planes {tuple(v0.shape)}")
    if tuple(out.shape) != (mloc, n) or not out.is_contiguous():
        raise ValueError(f"{what}: out must be a contiguous [{mloc}, {n}]")
    if acc is not None and (acc.dtype != torch.float32
                            or tuple(acc.shape) != (mloc, n)
                            or not acc.is_contiguous()):
        raise ValueError(f"{what}: acc must be a contiguous f32 "
                         f"[{mloc}, {n}]")
    if acc is None and not (first and last):
        raise ValueError(f"{what}: only a first-and-last step may omit acc")
    off = plane_window(v0, src, k4s, c0)
    # (v0, v1, codes, slot, acc, out, M, N, K4, ldp, first, last, dtype,
    #  out_dtype, tile, stream)
    fn = _build.load("ring24", "ring24_launch", "pppppp" "iiii" "iiiii" "p")
    with torch.cuda.device(dev):
        _build.check(fn(
            v0.data_ptr() + off * v0.element_size(),
            v1.data_ptr() + off * v1.element_size(),
            codes.data_ptr() + off,
            slot.data_ptr(),
            None if acc is None else acc.data_ptr() + c0 * n * 4,
            out.data_ptr() + c0 * n * out.element_size(),
            mt, n, k4s, v0.stride(0), int(first), int(last),
            DTYPE_CODES[v0.dtype], DTYPE_CODES[out.dtype],
            card_tile(dev, mt, n, 4 * k4s), _build.stream_ptr(v0)), what)


def ring_step_cuda(v0, v1, codes, slot, acc, out, *, src: int, c0: int,
                   mt: int, first: bool, last: bool) -> None:
    """Launch K7 for one step of :func:`spmm_24_ring_explicit`; the contract
    of :func:`ring_step_plain`. Planes may be a window of larger planes
    (unit column stride, one row stride)."""
    _launch(v0, v1, codes, slot, acc, out, src=src, c0=c0, mt=mt,
            first=first, last=last, what="ring_step_cuda")
    ring_step_cuda.launches += 1


ring_step_cuda.launches = 0


def ring_step_tiled_cuda(v0, v1, codes, slot, acc, out, *, src: int, c0: int,
                         mt: int, first: bool, last: bool) -> None:
    """Launch K7 for one (m-tile, step) of :func:`spmm_24_ring_tiled`."""
    _launch(v0, v1, codes, slot, acc, out, src=src, c0=c0, mt=mt,
            first=first, last=last, what="ring_step_tiled_cuda")
    ring_step_tiled_cuda.launches += 1


ring_step_tiled_cuda.launches = 0


def _ring(s: Sparse24, b: torch.Tensor, mesh: Mesh, axis: str, out_dtype,
          m_tile: Optional[int], tiled: bool, name: str) -> torch.Tensor:
    *lead, m, _ = s.shape
    if len(mesh.shape) != 1:
        # The Pallas kernels address neighbours by the flat device id.
        raise ValueError(f"{name} needs a 1-D mesh (got {mesh.shape})")
    p = mesh.shape[axis]
    m_total = rows_of(s)
    if m_total % p:
        raise ValueError(f"rows {m_total} % P {p} != 0")
    k4 = s.values0.shape[-2]
    if k4 % p:
        raise ValueError(f"k4 {k4} % P {p} != 0")
    k4s, n, mloc = k4 // p, b.shape[-1], m_total // p
    mt = (m_tile or _pick_mt(mloc)) if tiled else mloc
    if mloc % mt:
        raise ValueError(f"m_tile {mt} must divide mloc {mloc}")
    n_mt = mloc // mt
    out_dtype = out_dtype or torch.promote_types(s.dtype, b.dtype)
    dtype = torch.promote_types(s.dtype, b.dtype)
    devices = mesh.axis_devices(axis)
    cuda = devices[0].type == "cuda"
    if cuda and (dtype not in DTYPE_CODES or out_dtype not in DTYPE_CODES):
        raise TypeError(f"{name} takes float32/bfloat16, not {dtype} -> "
                        f"{out_dtype}")
    if cuda:
        _build.refuse_grad(name, s.values0, s.values1, b)
    step = ((ring_step_tiled_cuda if tiled else ring_step_cuda) if cuda
            else ring_step_plain)

    def queue() -> torch.Tensor:
        return _schedule(s, b, devices, p, k4s, mloc, mt, n_mt, dtype,
                         out_dtype, step)

    if cuda and ring_graph.captures(devices, s.values0, b):
        key = ring_graph.graph_key(
            s.values0, s.values1, s.codes, b, shape=s.shape,
            out_dtype=out_dtype, route=name, m_tile=mt, devices=devices,
            step=step)
        # the wrappers count under their module names, which a caller may
        # have rebound (a stand-in step with a ``launches`` attribute)
        counters = tuple(dict.fromkeys(
            f for f in (ring_step_cuda, ring_step_tiled_cuda)
            if hasattr(f, "launches")))
        out = ring_graph.run(key, queue, devices[0], counters)
    else:
        out = queue()
    return out.reshape(*lead, m, n)


def _schedule(s: Sparse24, b: torch.Tensor, devices, p: int, k4s: int,
              mloc: int, mt: int, n_mt: int, dtype, out_dtype,
              step) -> torch.Tensor:
    """Queue one ring (every m-tile) on the ranks' streams; returns C
    ``[rows, n]`` on the planes' device, ready in the caller's stream
    order."""
    k4, n, m_total = k4s * p, b.shape[-1], mloc * p
    home = s.values0.device
    # Per rank: its plane slab, its B shard, two comm slots, an f32
    # accumulator and its C rows (a view of C where it lies on C's device).
    slabs = plane_slabs(s, p, devices)
    if s.dtype != dtype:  # K7 multiplies like types
        slabs = [(v0.to(dtype), v1.to(dtype), codes.contiguous())
                 for v0, v1, codes in slabs]
    bp = pad_rows(b, 4 * k4).to(dtype)
    shards = [bp[r * 4 * k4s:(r + 1) * 4 * k4s].to(d)
              for r, d in enumerate(devices)]
    comm = [torch.empty((2, 4 * k4s, n), dtype=dtype, device=d)
            for d in devices]
    accs = [torch.empty((mloc, n), dtype=torch.float32, device=d)
            if p > 1 else None for d in devices]
    out = torch.empty((m_total, n), dtype=out_dtype, device=home)
    outs = [out[r * mloc:(r + 1) * mloc] if d == home
            else torch.empty((mloc, n), dtype=out_dtype, device=d)
            for r, d in enumerate(devices)]
    ranks = Ranks(devices, (home, b.device))
    rk_ = ranks.ranks

    # The last read of slot 1 in a tile: the credit the next tile's first
    # send (into slot 1) waits for.
    last_odd = p - 1 if p % 2 == 0 else p - 2
    arrived, free, done = {}, {}, {}
    for j in range(n_mt):
        for i in range(p):
            t = j * p + i
            slot, nxt = i % 2, (i + 1) % 2
            for r, rk in enumerate(rk_):
                right = (r + 1) % p
                if i == 0:
                    # (Re-)stage the local shard into slot 0 once this
                    # rank's reads of the previous tile are over; the
                    # event stands in for the Pallas staging barrier.
                    wait(rk.comm, done.get(r))
                    with on(rk.comm):
                        comm[r][0].copy_(shards[r], non_blocking=True)
                    arrived[r, t] = record(rk.comm)
                if i + 1 < p:
                    if i >= 1:
                        wait(rk.comm, free[right, t - 1], arrived[r, t])
                    elif j > 0:
                        wait(rk.comm, free[right, t - p + last_odd])
                    send(rk, rk_[right], comm[right][nxt], comm[r][slot])
                    arrived[right, t + 1] = record(rk.comm)
                wait(rk.compute, arrived[r, t])
                v0, v1, codes = slabs[r]
                with on(rk.compute):
                    step(v0, v1, codes, comm[r][slot], accs[r], outs[r],
                         src=(r - i) % p, c0=j * mt, mt=mt, first=i == 0,
                         last=i == p - 1)
                if i < p - 2 or (i == last_odd and j < n_mt - 1):
                    # Done reading comm[slot]: the credit to the left
                    # neighbour, once our own copy of the slot has left.
                    if i + 1 < p:
                        wait(rk.compute, arrived[right, t + 1])
                    free[r, t] = record(rk.compute)
                if i == p - 1:
                    done[r] = record(rk.compute)
    for r, rk in enumerate(rk_):
        if devices[r] != home:
            with on(rk.compute):
                out[r * mloc:(r + 1) * mloc].copy_(outs[r], non_blocking=True)
    ranks.end()
    return out


def spmm_24_ring_explicit(s: Sparse24, b: torch.Tensor, mesh: Mesh,
                          axis: str = "model", *,
                          out_dtype=None) -> torch.Tensor:
    """Ring 2:4 SpMM with an explicit double-buffered exchange of B shards,
    overlapped with kernel K7; replaces ``spmm_24_ring_pallas``.

    Same contract as :func:`~.spmm_sharded.spmm_24_ring` (A row-partitioned,
    B k-sharded, batched A folded into rows); needs a 1-D mesh, rows % P ==
    0 and k4 % P == 0. Natural-order B in, the C of ``spmm_24_ring`` out.
    """
    return _ring(s, b, mesh, axis, out_dtype, None, False,
                 "spmm_24_ring_explicit")


def spmm_24_ring_tiled(s: Sparse24, b: torch.Tensor, mesh: Mesh,
                       axis: str = "model", *, out_dtype=None,
                       m_tile: Optional[int] = None) -> torch.Tensor:
    """:func:`spmm_24_ring_explicit` with the rank's rows in m-tiles of
    ``m_tile`` columns (default :func:`_pick_mt`), a whole ring per tile;
    replaces ``spmm_24_ring_tiled_pallas``. ``m_tile`` must divide the
    rank's row count."""
    return _ring(s, b, mesh, axis, out_dtype, m_tile, True,
                 "spmm_24_ring_tiled")
