"""Probes of K2's fused prune+compress route: its copy floor, its ranking,
its compaction and its store layout apart.

Port of ``experiments/tpu_fused_probe.py``, which isolates the cost parts of
the TPU's fused prune+compress. The kernels are K2's body
(``csrc/compress24_tile.cuh``) with a compile-time mode
(``csrc/compress_units.cu``), on K2's tiles (``prune_kernel.compress_plan``:
R rows by KT columns of ``x [rows, k]``), its persistent grid and its
ring, so the times come from the code that K2 runs. Per tile:

* ``io`` (``kernel_io``): v0 = v1 = the f32 sum of ``x[r0:r0+8,
  c0:c0+min(128, KT)]`` in bf16 over the tile's plane block, codes 1;
* ``rank`` (``kernel_rank``): v0 / v1 = the f32 sum of the first / second
  kept value of every group of the tile, codes 1;
* ``dot1`` (``kernel_dot1``): v0 = v1 = the first kept value of each
  group, codes = ``uint8(int32(v0))`` (wrapping: -1 is 255);
* ``rm`` (``kernel_rm``): K2's planes stored row-major ``[rows, K4]``, bit
  for bit ``compress_24``'s transposed.

io, rank and dot1 write k-major planes ``[K4, rows]`` as K2 does; columns
past k read as zero, rows past ``rows`` are neither summed nor stored. Held
to the JAX kernels in ``tests/test_torch_fused_probe.py``.

A measurement module: the port does not import it. :func:`fused_cuda`
launches its kernel or raises; the tests call :func:`fused_plain`.

Usage: python -m sparsifyme_tpu_torch.bench.fused_probe   (needs one GPU)
"""

from __future__ import annotations

import collections
import sys
from typing import Tuple

import torch
import torch.nn.functional as F

from .. import _build
from ..ops.kernels.prune_kernel import _round_up, compress_24_plain, \
    compress_plan

MODES = {"io": 1, "rank": 2, "dot1": 3, "rm": 4}
# (w, v0, v1, codes, M, k, K4, R, KT, mode, device, stream)
COMPRESS_UNITS = _build.Entry("compress_units", "compress_units_launch",
                              "pppp" "iiiii" "ii" "p")
# rows x kp (bf16): the JAX probe's two shapes, 12544x64x256 and x576 at
# b = 32 folded into the rows
SHAPES = [(401408, 256), (401408, 576)]

Planes = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def fused_cuda(x: torch.Tensor, mode: str) -> Planes:
    """Launch K2's body in ``mode`` on a CUDA bf16 ``x [rows, k]``; returns
    ``(v0, v1, codes)``, ``[K4, rows]`` (``[rows, K4]`` for ``rm``)."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} is not one of {tuple(MODES)}")
    if not x.is_cuda:
        raise ValueError("fused_cuda needs a CUDA tensor")
    if x.dtype != torch.bfloat16 or x.ndim != 2 or x.shape[1] == 0:
        raise ValueError(f"fused_cuda takes bf16 [rows, k], k > 0, got "
                         f"{x.dtype} {tuple(x.shape)}")
    x = x.contiguous()
    rows, k = x.shape
    k4 = _round_up(k, 64) // 4
    plan = compress_plan(rows, k, x.element_size())
    shape = (rows, k4) if mode == "rm" else (k4, rows)
    v0 = torch.empty(shape, dtype=x.dtype, device=x.device)
    v1 = torch.empty_like(v0)
    codes = torch.empty(shape, dtype=torch.uint8, device=x.device)
    COMPRESS_UNITS(x.get_device(), x.data_ptr(), v0.data_ptr(),
                   v1.data_ptr(), codes.data_ptr(), rows, k, k4,
                   plan.rows_per_tile, plan.k_tile, MODES[mode])
    fused_cuda.launches[mode] += 1
    return v0, v1, codes


fused_cuda.launches = collections.Counter()  # by mode


def _tile_sums(p: torch.Tensor, r: int, cols: int, head_rows: int = None,
               head_cols: int = None) -> torch.Tensor:
    """``p [rows, C]`` summed in f32 per tile of ``r`` rows by ``cols``
    columns (rows past ``rows`` zero), over each tile's first ``head_rows``
    rows and ``head_cols`` columns (all where None): ``[ceil(rows/r),
    C/cols]``."""
    rows, c = p.shape
    pp = F.pad(p.float(), (0, 0, 0, _round_up(rows, r) - rows))
    return pp.reshape(-1, r, c // cols, cols)[
        :, :head_rows, :, :head_cols].sum((1, 3))


def _broadcast(sums: torch.Tensor, r: int, kt: int, rows: int,
               dtype: torch.dtype) -> torch.Tensor:
    """Per-tile values ``[row tiles, k-tiles]`` over the k-major planes
    ``[K4, rows]``: plane row g, column m takes tile (m // r, 4g // kt)."""
    return (sums.to(dtype).repeat_interleave(kt // 4, dim=1)
            .repeat_interleave(r, dim=0)[:rows].T.contiguous())


def fused_plain(x: torch.Tensor, mode: str) -> Planes:
    """Plain version of :func:`fused_cuda` on K2's tiles for ``x``."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} is not one of {tuple(MODES)}")
    rows, k = x.shape
    kp = _round_up(k, 64)
    plan = compress_plan(rows, k, x.element_size())
    r, kt = plan.rows_per_tile, plan.k_tile
    v0, v1, codes = compress_24_plain(x)
    if mode == "rm":
        return v0.T.contiguous(), v1.T.contiguous(), codes.T.contiguous()
    if mode == "dot1":
        return v0, v0.clone(), v0.float().to(torch.int32).to(torch.uint8)
    ones = torch.ones_like(codes)
    if mode == "rank":  # the kept values' sums: the planes' per tile
        s0, s1 = (_tile_sums(p.T, r, kt // 4) for p in (v0, v1))
        return (_broadcast(s0, r, kt, rows, x.dtype),
                _broadcast(s1, r, kt, rows, x.dtype), ones)
    head = _tile_sums(F.pad(x, (0, kp - k)), r, kt, 8, min(128, kt))
    s = _broadcast(head, r, kt, rows, x.dtype)
    return s, s.clone(), ones


def floor_ms(rows: int, kp: int, gbps: float) -> float:
    """The JAX probe's floor: ``rows * kp * (2 + 1.25)`` bytes (x read,
    the compact planes written) at ``gbps``."""
    return rows * kp * 3.25 / (gbps * 1e9) * 1e3


def same_planes(got: Planes, want: Planes) -> bool:
    return all(g.shape == w.shape and g.dtype == w.dtype and torch.equal(g, w)
               for g, w in zip(got, want))


def errors(got: Planes, want: Planes) -> Tuple[float, float]:
    """The largest error of v0 and v1, and it over the largest ``|want|``
    of that plane."""
    err = rel = 0.0
    for g, w in zip(got[:2], want[:2]):
        e = float((g.float() - w.float()).abs().max())
        err = max(err, e)
        rel = max(rel, e / max(float(w.float().abs().max()), 1e-30))
    return err, rel


def check(x: torch.Tensor, mode: str) -> Tuple[float, float]:
    """Hold one launch in ``mode`` to the plain version: io and rank (bf16
    sums in another order) within 2e-2 with codes equal, dot1 and rm
    exactly. Returns :func:`errors` (zeros where exact)."""
    got, want = fused_cuda(x, mode), fused_plain(x, mode)
    if mode in ("dot1", "rm"):
        if not same_planes(got, want):
            raise AssertionError(f"fused {mode}: planes differ from plain")
        return 0.0, 0.0
    err = errors(got, want)
    if not (err[1] <= 2e-2 and torch.equal(got[2], want[2])):
        raise AssertionError(f"fused {mode}: rel err {err[1]} > 2e-2 or "
                             "codes differ")
    return err


def probe_shape(rows: int, kp: int, gen: torch.Generator, *,
                iters: int = 8, reps: int = 3) -> dict:
    """Every mode, ``rm`` with the transposes after it, and K2's fused
    route at ``x [rows, kp]`` on the card: each mode held to its plain
    version (:func:`check`; its relative error kept) and timed."""
    from ..ops.kernels.prune_kernel import prune_compress_24_cuda
    from ..utils.timing import time_kernel

    x = torch.randn((rows, kp), generator=gen,
                    device=gen.device).to(torch.bfloat16)
    res = {"shape": f"{rows}x{kp}", "ms": {}, "err": {}}
    for mode in MODES:
        res["err"][mode] = check(x, mode)[1]
        res["ms"][mode] = time_kernel(lambda y, mode=mode: fused_cuda(y, mode),
                                      (x,), iters=iters, reps=reps).ms

    def rm_transposed(y):
        return tuple(p.t().contiguous() for p in fused_cuda(y, "rm"))
    res["ms"]["rm+t"] = time_kernel(rm_transposed, (x,), iters=iters,
                                    reps=reps).ms
    res["ms"]["shipped"] = time_kernel(prune_compress_24_cuda, (x,),
                                       iters=iters, reps=reps).ms
    return res


def main() -> int:
    if not torch.cuda.is_available():
        print("fused_probe: needs a CUDA device", file=sys.stderr)
        return 1
    from .roofline import H100, measure_machine
    from .units_probe import card_line

    card = card_line()
    measured = measure_machine().hbm_gbps
    print(f"card: {card} | memory rate: sheet {H100.hbm_gbps:.1f} GB/s, "
          f"measured {measured:.1f} GB/s", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for rows, kp in SHAPES:
        r = probe_shape(rows, kp, gen)
        sheet, meas = (floor_ms(rows, kp, g) for g in (H100.hbm_gbps,
                                                       measured))
        plan = compress_plan(rows, kp, 2)
        print(f"== rows={rows} kp={kp} tile {plan.rows_per_tile}x"
              f"{plan.k_tile}: floor {sheet:.4f} ms (sheet), {meas:.4f} ms "
              f"(measured) | {card}", flush=True)
        for name, ms in r["ms"].items():
            print(f"  {name:8s} {ms:.4f} ms (x{ms / sheet:.2f} of the "
                  f"sheet's floor, x{ms / meas:.2f} of the measured)",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
