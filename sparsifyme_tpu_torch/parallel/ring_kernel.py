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

K7 has two step designs (the rings' ``design`` knob, :func:`ring_design`).
``wgmma_sp`` (``csrc/ring24_wg.cu``: :func:`ring_step_wg_cuda`, and
:func:`ring_step_wg_tiled_cuda` for the tiled route) contracts a step on
the TMA-fed ``wgmma.sp`` tile of K3's ``wgmma_sp`` route, reading a window
of the operand that ``ops.sparse24.pack_wg`` packed once into the
container, with the accumulator in the tile's epilogue; a ring takes it
where :func:`ring_wg_refusal` finds nothing against it. ``mma_sp``
(``csrc/ring24.cu``: :func:`ring_step_cuda`, :func:`ring_step_tiled_cuda`)
runs on the planes with K3's ``mma.sp`` tile, or the simple one (f32,
ragged shapes), and takes every other ring. On a one-card mesh each rank
reads its window of the container's operand in place; a mesh over several
cards copies each rank's slab of it to its card, as it does the planes;
on a process mesh the process's shard carries its own operand (pack it
once after ``shard_planes``).

On a mesh whose ranks and operands share one card, a ring is replayed as a
CUDA graph (:mod:`.ring_graph`) once it has been called twice with the same
operands, mesh, route and step function: the first call runs eagerly, the
second captures and replays. Meshes over several cards queue every call
eagerly.
Ranks on CPU devices run the same schedule in order with the plain version
of K7, and never capture.

On a process mesh (one rank per process, :mod:`.mesh`) each process runs
its rank's ring on its blocks (the process contract: this rank's planes
from :func:`~.spmm_sharded.shard_planes`, its k-shard of B zero-padded to
``4 * k4`` rows, its block of C back), eagerly. It keeps the two comm
slots: the contraction of step i is K7 on the caller's stream, while one
``dist.batch_isend_irecv`` pair, issued on a comm stream, sends the held
slot to the right neighbour's other slot and receives the left one's into
this rank's other slot. The capacity credit becomes the order of the NCCL
calls against the compute stream: the receive into a slot is issued only
after the event that the last K7 reading that slot has run (the restaging
of slot 0 for the next m-tile likewise), and K7 waits for the event after
the exchange that filled its slot.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Optional, Tuple

import torch

from .. import _build
from ..containers import Sparse24
from ..ops.kernels.prune_kernel import DTYPE_CODES
from ..ops.kernels.spmm24_kernel import (DESIGNS, H100_SMS, WG_BM, WG_KS,
                                         WG_WORDS, WgPlan, card_tile,
                                         expand_planes, sm_count, wg_dense,
                                         wg_plan, wg_walk)
from ..ops.sparse24 import check_wg
from . import ring_graph
from .mesh import Mesh
from .spmm_sharded import (Rank, Ranks, check_shard, finish, on,
                           p2p_exchange, pad_rows, plane_slabs, record,
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


# --- the wgmma_sp step -------------------------------------------------------

WG_GROUPS = WG_KS // 4  # k-groups of one k-step of the packed operand
# ring24_wg_launch's ctypes spec: (a, slot, acc, out, ws, a_ktp, a_tiles,
# kt0, mt0, M, N, K, first, last, out_dtype, bn, splits, kps, grid, device,
# stream)
RING_WG_SPEC = "ppppp" "iiii" "iii" "iii" "iiii" "i" "p"


def ring_wg_refusal(s: Sparse24, b: torch.Tensor, *, out_dtype, mloc: int,
                    mt: int, k4s: int) -> Optional[str]:
    """Why K7's ``wgmma_sp`` step cannot take a ring (``None``: it can):
    the container must carry ``wg`` (``ops.sparse24.pack_wg``), planes and
    B be bf16 and C bf16 or f32, and a rank's rows (``mloc``), the m-tile
    (``mt``), n and the k-slice (``k4s`` groups) whole tiles of the packed
    operand (128 rows, 64 columns, 16 groups)."""
    if s.wg is None:
        return "the container carries no wg (ops.sparse24.pack_wg)"
    if s.dtype != torch.bfloat16 or b.dtype != torch.bfloat16 or \
            out_dtype not in (torch.bfloat16, torch.float32):
        return (f"{s.dtype} planes, {b.dtype} b, {out_dtype} out (bf16 in, "
                "bf16 or f32 out)")
    n = b.shape[-1]
    if mloc % WG_BM or mt % WG_BM or n % 64 or k4s % WG_GROUPS:
        return (f"rows a rank {mloc} or m-tile {mt} % {WG_BM}, n {n} % 64 "
                f"or k4 a rank {k4s} % {WG_GROUPS}")
    return None


def ring_design(s: Sparse24, b: torch.Tensor, *, out_dtype, mloc: int,
                mt: int, k4s: int, design: Optional[str] = None) -> str:
    """The step design a ring takes: ``design`` where it is given
    (``"wgmma_sp"`` raising where :func:`ring_wg_refusal` refuses the
    ring), else ``"wgmma_sp"`` where it does not, else ``"mma_sp"``. A
    stale ``wg`` raises (``ops.sparse24.check_wg``) whatever the
    design."""
    if design not in (None,) + DESIGNS:
        raise ValueError(f"design {design!r} is not one of {DESIGNS}")
    check_wg(s)
    if design == "mma_sp":
        return design
    why = ring_wg_refusal(s, b, out_dtype=out_dtype, mloc=mloc, mt=mt,
                          k4s=k4s)
    if why is None:
        return "wgmma_sp"
    if design == "wgmma_sp":
        raise ValueError(f"design 'wgmma_sp' cannot take this ring: {why}")
    return "mma_sp"


def ring_wg_plan(mt: int, n: int, k: int, sms: int = H100_SMS) -> WgPlan:
    """The plan of K7's ``wgmma_sp`` step on an ``mt``-row window, ``n``
    columns and ``k = 4 * k4s`` logical k: ``spmm24_kernel.wg_plan`` with
    the f32 accumulator's bytes (read and written, 8 B a C element) in its
    byte floor, choosing between 128 and 64 columns: a window of less than
    a wave of 128-column units (the tiled route's) runs twice the units at
    64, each of half the work."""
    return wg_plan(mt, n, k, sms, extra_bytes=8.0 * mt * n,
                   widths=(128, 64))


@functools.lru_cache(maxsize=256)
def card_ring_wg_plan(index: int, mt: int, n: int, k: int) -> WgPlan:
    """:func:`ring_wg_plan` on card ``index``, once per shape and card."""
    return ring_wg_plan(mt, n, k, sm_count(index))


def ring_wg_walk(p: int, mloc: int, mt: int, n: int, k4s: int,
                 sms: int = H100_SMS
                 ) -> Dict[Tuple[int, int, int], List[Tuple[int, int, int]]]:
    """The blocks of the packed operand that K7's ``wgmma_sp`` step reads
    in one ring over a one-card mesh of ``p`` ranks: for each (rank, step,
    m-tile) of the schedule, its launch's units replayed in the kernel's
    order (``spmm24_kernel.wg_walk`` on :func:`ring_wg_plan`'s plan), each
    k-step of each unit as ``(operand k-step, operand m-tile, n-tile)``;
    operand m-tiles count from the container's first column."""
    plan = ring_wg_plan(mt, n, 4 * k4s, sms)
    units = [(m_tile, n_tile, kt)
             for walk in wg_walk(plan, mt, n, 4 * k4s)
             for m_tile, n_tile, _, kts in walk for kt in kts]
    out = {}
    for j in range(mloc // mt):
        for i in range(p):
            for r in range(p):
                kt0 = (r - i) % p * k4s // WG_GROUPS
                mt0 = (r * mloc + j * mt) // WG_BM
                out[r, i, j] = [(kt0 + kt, mt0 + m_tile, n_tile)
                                for m_tile, n_tile, kt in units]
    return out


def _wg_window(wg: torch.Tensor, tile0: int, slot: torch.Tensor, *,
               src: int, c0: int, mt: int, mloc: int, what: str
               ) -> Tuple[int, int]:
    """``(kt0, mt0)``: the step's first k-step and m-tile in ``wg``, after
    the checks both versions of the step make."""
    if wg.dim() != 3 or wg.shape[2] != WG_WORDS:
        raise ValueError(f"{what}: wg {tuple(wg.shape)} is not a packed "
                         "operand [ktp, tiles, 2304]")
    rows, n = slot.shape
    ktp, tiles = wg.shape[:2]
    k4s = rows // 4
    if rows % WG_KS or n % 64:
        raise ValueError(f"{what}: slot {tuple(slot.shape)} needs k % "
                         f"{WG_KS} == 0 and n % 64 == 0")
    kt0, mt0 = src * k4s // WG_GROUPS, tile0 + c0 // WG_BM
    if not (0 <= src and kt0 + k4s // WG_GROUPS <= ktp and 0 <= tile0 and
            tile0 + mloc // WG_BM <= tiles and c0 % WG_BM == 0 and
            mt % WG_BM == 0 and 0 < mt and c0 + mt <= mloc and
            mloc % WG_BM == 0):
        raise ValueError(f"{what}: window (src {src}, columns {c0}+{mt} of "
                         f"{mloc} from m-tile {tile0}) outside wg "
                         f"{tuple(wg.shape)} or off its tiles")
    return kt0, mt0


def ring_step_wg_plain(wg, tile0, slot, acc, out, *, src: int, c0: int,
                       mt: int, first: bool, last: bool) -> None:
    """Plain version of K7's ``wgmma_sp`` step: the window of the packed
    operand ``wg`` that the kernel reads (k-steps of the slot's k-slice
    ``src``, m-tiles from ``tile0 + c0 / 128``: ``tile0`` is the rank's
    first m-tile in ``wg``) decoded from the packed words
    (``spmm24_kernel.wg_dense``), then :func:`ring_step_plain`'s
    arithmetic."""
    kt0, mt0 = _wg_window(wg, tile0, slot, src=src, c0=c0, mt=mt,
                          mloc=out.shape[0], what="ring_step_wg_plain")
    kts, cs = slot.shape[0] // WG_KS, slice(c0, c0 + mt)
    a_t = wg_dense(wg[kt0:kt0 + kts, mt0:mt0 + mt // WG_BM])
    part = a_t.T @ slot.to(torch.float32)
    if not first:
        part = part + acc[cs]
    (out if last else acc)[cs] = part


def _launch_wg(wg, tile0, slot, acc, out, *, src, c0, mt, first, last,
               what) -> None:
    if not (wg.is_cuda and slot.is_cuda and out.is_cuda):
        raise ValueError(f"{what} needs CUDA tensors")
    index = wg.get_device()
    if any(t.get_device() != index
           for t in (slot, out) + (() if acc is None else (acc,))):
        raise ValueError(f"{what}: operands on more than one device")
    if wg.dtype != torch.int32 or not wg.is_contiguous():
        raise ValueError(f"{what}: wg must be the contiguous int32 operand "
                         "of pack_wg")
    if slot.dtype != torch.bfloat16 or \
            out.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{what} takes a bf16 slot and bf16 or f32 out, not "
                        f"{slot.dtype} -> {out.dtype}")
    mloc, n = out.shape[0], slot.shape[1]
    kt0, mt0 = _wg_window(wg, tile0, slot, src=src, c0=c0, mt=mt,
                          mloc=mloc, what=what)
    if not slot.is_contiguous():
        raise ValueError(f"{what}: slot must be contiguous")
    if tuple(out.shape) != (mloc, n) or not out.is_contiguous():
        raise ValueError(f"{what}: out must be a contiguous [{mloc}, {n}]")
    if acc is not None and (acc.dtype != torch.float32
                            or tuple(acc.shape) != (mloc, n)
                            or not acc.is_contiguous()):
        raise ValueError(f"{what}: acc must be a contiguous f32 "
                         f"[{mloc}, {n}]")
    if acc is None and not (first and last):
        raise ValueError(f"{what}: only a first-and-last step may omit acc")
    k = slot.shape[0]
    plan = card_ring_wg_plan(index, mt, n, k)
    ws = (torch.empty((plan.splits, mt, n), dtype=torch.float32,
                      device=out.device) if plan.splits > 1 else None)
    fn = _build.load("ring24_wg", "ring24_wg_launch", RING_WG_SPEC)
    _build.check(fn(
        wg.data_ptr(), slot.data_ptr(),
        None if acc is None else acc.data_ptr() + c0 * n * 4,
        out.data_ptr() + c0 * n * out.element_size(), _build.ptr(ws),
        wg.shape[0], wg.shape[1], kt0, mt0, mt, n, k, int(first), int(last),
        DTYPE_CODES[out.dtype], plan.bn, plan.splits, plan.kps, plan.grid,
        index, _build.stream_ptr(out)), what)


def ring_step_wg_cuda(wg, tile0, slot, acc, out, *, src: int, c0: int,
                      mt: int, first: bool, last: bool) -> None:
    """Launch K7's ``wgmma_sp`` step (``csrc/ring24_wg.cu``) for one step
    of :func:`spmm_24_ring_explicit`; the contract of
    :func:`ring_step_wg_plain`, under :func:`card_ring_wg_plan`'s plan.
    Raises on anything the tile does not take."""
    _launch_wg(wg, tile0, slot, acc, out, src=src, c0=c0, mt=mt,
               first=first, last=last, what="ring_step_wg_cuda")
    ring_step_wg_cuda.launches += 1


ring_step_wg_cuda.launches = 0


def ring_step_wg_tiled_cuda(wg, tile0, slot, acc, out, *, src: int, c0: int,
                            mt: int, first: bool, last: bool) -> None:
    """Launch K7's ``wgmma_sp`` step for one (m-tile, step) of
    :func:`spmm_24_ring_tiled`."""
    _launch_wg(wg, tile0, slot, acc, out, src=src, c0=c0, mt=mt,
               first=first, last=last, what="ring_step_wg_tiled_cuda")
    ring_step_wg_tiled_cuda.launches += 1


ring_step_wg_tiled_cuda.launches = 0


def _step(cuda: bool, tiled: bool, design: str):
    """The step function of a ring (looked up when the ring starts, so that
    a wrapper rebound in this module is the one called)."""
    if design == "wgmma_sp":
        if not cuda:
            return ring_step_wg_plain
        return ring_step_wg_tiled_cuda if tiled else ring_step_wg_cuda
    if not cuda:
        return ring_step_plain
    return ring_step_tiled_cuda if tiled else ring_step_cuda


def _counters():
    """The step wrappers whose launches a captured ring accounts for (a
    caller may have rebound one to a stand-in with a ``launches``
    attribute)."""
    return tuple(dict.fromkeys(
        f for f in (ring_step_cuda, ring_step_tiled_cuda, ring_step_wg_cuda,
                    ring_step_wg_tiled_cuda) if hasattr(f, "launches")))


def _ring(s: Sparse24, b: torch.Tensor, mesh: Mesh, axis: str, out_dtype,
          m_tile: Optional[int], tiled: bool, name: str,
          design: Optional[str]) -> torch.Tensor:
    *lead, m, _ = s.shape
    if len(mesh.shape) != 1:
        # The Pallas kernels address neighbours by the flat device id.
        raise ValueError(f"{name} needs a 1-D mesh (got {mesh.shape})")
    if mesh.is_process_mesh:
        return _ring_processes(s, b, mesh, axis, out_dtype, m_tile, tiled,
                               name, design)
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
    design = ring_design(s, b, out_dtype=out_dtype, mloc=mloc, mt=mt,
                         k4s=k4s, design=design)
    step = _step(cuda, tiled, design)

    def queue() -> torch.Tensor:
        return _schedule(s, b, devices, p, k4s, mloc, mt, n_mt, dtype,
                         out_dtype, step, design)

    if cuda and ring_graph.captures(devices, s.values0, b):
        wg = s.wg.packed if design == "wgmma_sp" else None
        key = ring_graph.graph_key(
            s.values0, s.values1, s.codes, b, shape=s.shape,
            out_dtype=out_dtype, route=name, m_tile=mt, devices=devices,
            step=step, design=design, wg=wg)
        out = ring_graph.run(key, queue, devices[0], _counters())
    else:
        out = queue()
    return out.reshape(*lead, m, n)


def _wg_slabs(s: Sparse24, p: int, devices):
    """Rank r's A for the ``wgmma_sp`` step, ``(operand, its first
    m-tile)``: the container's packed operand itself where it lies on the
    rank's device (the rank's window starts at m-tile ``r * mloc / 128``),
    else the rank's slab of it copied to its card."""
    wg = s.wg.packed
    tiles = wg.shape[1] // p
    return [(wg, r * tiles) if d == wg.device else
            (wg[:, r * tiles:(r + 1) * tiles].to(
                d, memory_format=torch.contiguous_format), 0)
            for r, d in enumerate(devices)]


def _schedule(s: Sparse24, b: torch.Tensor, devices, p: int, k4s: int,
              mloc: int, mt: int, n_mt: int, dtype, out_dtype,
              step, design: str) -> torch.Tensor:
    """Queue one ring (every m-tile) on the ranks' streams; returns C
    ``[rows, n]`` on the planes' device, ready in the caller's stream
    order."""
    k4, n, m_total = k4s * p, b.shape[-1], mloc * p
    home = s.values0.device
    # Per rank: its A (plane slab, or its window of the packed operand),
    # its B shard, two comm slots, an f32 accumulator and its C rows (a
    # view of C where it lies on C's device).
    if design == "wgmma_sp":
        slabs = _wg_slabs(s, p, devices)
    else:
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
                with on(rk.compute):
                    step(*slabs[r], comm[r][slot], accs[r], outs[r],
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


def _ring_processes(s: Sparse24, b: torch.Tensor, mesh: Mesh, axis: str,
                    out_dtype, m_tile: Optional[int], tiled: bool,
                    name: str, design: Optional[str]) -> torch.Tensor:
    """This rank's ring on a process mesh (the module docstring)."""
    mesh.check(name, s.values0, b)
    p = mesh.shape[axis]
    k4s = check_shard(s, b, p)
    n, mloc = b.shape[-1], s.values0.shape[-1]
    mt = (m_tile or _pick_mt(mloc)) if tiled else mloc
    if mloc % mt:
        raise ValueError(f"m_tile {mt} must divide mloc {mloc}")
    out_dtype = out_dtype or torch.promote_types(s.dtype, b.dtype)
    dtype = torch.promote_types(s.dtype, b.dtype)
    dev = s.values0.device
    cuda = dev.type == "cuda"
    if cuda and (dtype not in DTYPE_CODES or out_dtype not in DTYPE_CODES):
        raise TypeError(f"{name} takes float32/bfloat16, not {dtype} -> "
                        f"{out_dtype}")
    if cuda:
        _build.refuse_grad(name, s.values0, s.values1, b)
    design = ring_design(s, b, out_dtype=out_dtype, mloc=mloc, mt=mt,
                         k4s=k4s, design=design)
    step = _step(cuda, tiled, design)
    if design == "wgmma_sp":  # the shard's own operand
        a_ops = (s.wg.packed, 0)
    else:
        a_ops = (s.values0, s.values1, s.codes)
        if s.dtype != dtype:  # K7 multiplies like types
            a_ops = (a_ops[0].to(dtype), a_ops[1].to(dtype), a_ops[2])
    shard = b.to(dtype).contiguous()
    slots = torch.empty((2, 4 * k4s, n), dtype=dtype, device=dev)
    acc = (torch.empty((mloc, n), dtype=torch.float32, device=dev)
           if p > 1 else None)
    out = torch.empty((mloc, n), dtype=out_dtype, device=dev)
    me = mesh.axis_index(axis)
    main = torch.cuda.current_stream(dev) if cuda else None
    comm = Rank(dev).comm
    # free[x]: after the last K7 that read slot x (the capacity credit)
    free = [record(main), None]
    for j in range(mloc // mt):
        for i in range(p):
            slot, nxt = i % 2, (i + 1) % 2
            if i == 0:  # (re-)stage the local shard into slot 0
                wait(comm, free[0])
                with on(comm):
                    slots[0].copy_(shard, non_blocking=True)
                arrived = record(comm)
            works = []
            if i + 1 < p:
                wait(comm, free[nxt])
                with on(comm):
                    works = p2p_exchange(slots[slot], slots[nxt], mesh, axis)
            wait(main, arrived)
            step(*a_ops, slots[slot], acc, out, src=(me - i) % p,
                 c0=j * mt, mt=mt, first=i == 0, last=i == p - 1)
            free[slot] = record(main)
            if works:
                arrived = finish(comm, works)
    wait(main, record(comm))
    return out.reshape(*s.shape[:-1], n)


def spmm_24_ring_explicit(s: Sparse24, b: torch.Tensor, mesh: Mesh,
                          axis: str = "model", *, out_dtype=None,
                          design: Optional[str] = None) -> torch.Tensor:
    """Ring 2:4 SpMM with an explicit double-buffered exchange of B shards,
    overlapped with kernel K7; replaces ``spmm_24_ring_pallas``.

    Same contract as :func:`~.spmm_sharded.spmm_24_ring` (A row-partitioned,
    B k-sharded, batched A folded into rows); needs a 1-D mesh, rows % P ==
    0 and k4 % P == 0. Natural-order B in, the C of ``spmm_24_ring`` out.
    ``design`` picks K7's step (:func:`ring_design`: ``None`` takes
    ``"wgmma_sp"`` where the container carries ``wg`` from
    ``ops.sparse24.pack_wg`` and :func:`ring_wg_refusal` allows it, else
    ``"mma_sp"``; a forced ``"wgmma_sp"`` that the step cannot take
    raises).
    """
    return _ring(s, b, mesh, axis, out_dtype, None, False,
                 "spmm_24_ring_explicit", design)


def spmm_24_ring_tiled(s: Sparse24, b: torch.Tensor, mesh: Mesh,
                       axis: str = "model", *, out_dtype=None,
                       m_tile: Optional[int] = None,
                       design: Optional[str] = None) -> torch.Tensor:
    """:func:`spmm_24_ring_explicit` with the rank's rows in m-tiles of
    ``m_tile`` columns (default :func:`_pick_mt`), a whole ring per tile;
    replaces ``spmm_24_ring_tiled_pallas``. ``m_tile`` must divide the
    rank's row count. ``design`` as in :func:`spmm_24_ring_explicit`."""
    return _ring(s, b, mesh, axis, out_dtype, m_tile, True,
                 "spmm_24_ring_tiled", design)
