"""The BASELINE.json benchmark configurations, runnable by number.

Counterpart of ``sparsifyme_tpu.bench.configs``; each runner returns (and
``main`` prints) a dict with the keys of the JAX runner:

0. ResNet-18 shapes: magnitude-threshold prune + dense GEMM reference,
   fp32, on the CPU (BASELINE mandates the CPU).
1. 2:4 structured prune + SpMM on ResNet-50 shapes, bf16 (the harness
   sweep).
2. Batched COO SpMM across the ResNet-101 layers, one shared sparse A,
   50-99.5% sparsity: the gather/segment-sum oracle and kernel K6 against
   the dense GEMM, with the dense->COO conversion cost and the crossover
   sparsity per shape.
3. The fused prune->compress->matmul plan on ResNet-152 shapes.
4. Row-partitioned 2:4 SpMM over 1, 2, 4 and 8 ranks with the ring exchange
   of B shards (weak scaling), and K7's two rings against the ppermute one.

Runners take ``device``: ``None`` is the GPU (config 0: the CPU). With
``--cpu`` the plain versions run on the CPU (config 4 on eight CPU ranks);
their times mean nothing. Config 4 with ``--processes`` runs one rank per
process at P = the world size, under ``torch.distributed.run`` (NCCL: one
card per rank; with ``--cpu``, gloo ranks on the CPU); rank 0 prints the
line.

Usage: python -m sparsifyme_tpu_torch.bench.configs <0..4> [--quick] [--cpu]
       python -m torch.distributed.run --standalone --nproc-per-node=P \
           -m sparsifyme_tpu_torch.bench.configs 4 --processes [--quick] \
           [--cpu]
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time
from typing import Dict

import numpy as np
import torch

from .. import _build
from ..models.resnet_shapes import resnet_conv_shapes
from ..utils.timing import time_kernel
from .harness import geomean as _geomean
from .harness import run_model_sweep


def config0_threshold_gemm_cpu(quick: bool = False, device="cpu") -> Dict:
    """ResNet-18: magnitude-threshold prune + dense GEMM, fp32."""
    from ..ops.gemm import gemm_f32
    from ..ops.prune import prune_threshold

    dev = _build.resolve_device(device)
    shapes = resnet_conv_shapes("resnet18")
    if quick:
        shapes = shapes[:4]
    rows = []
    for s in sorted(set(shapes)):
        gen = torch.Generator(device=dev).manual_seed(0)
        a = torch.randn((s.b, s.m, s.k), generator=gen, device=dev)
        bm = torch.randn((s.k, s.n), generator=gen, device=dev)
        ap, mask = prune_threshold(a, 0.6745)  # |N(0,1)| median: ~50%
        sparsity = 1.0 - float(mask.mean())
        tp = time_kernel(lambda x: prune_threshold(x, 0.6745), (a,),
                         iters=4, reps=3)
        t = time_kernel(gemm_f32, (ap, bm), iters=4, reps=3)
        rows.append((s, sparsity, t.ms, tp.ms))
    return {
        "config": 0,
        "backend": dev.type,
        "layers": len(rows),
        "sparsity_mean": float(np.mean([r[1] for r in rows])),
        "gemm_ms_geomean": _geomean([r[2] for r in rows]),
        "prune_ms_geomean": _geomean([r[3] for r in rows]),
        "rows": [
            {"m": s.m, "n": s.n, "k": s.k, "b": s.b, "sparsity": sp,
             "gemm_ms": g, "prune_ms": p}
            for s, sp, g, p in rows
        ],
    }


def config1_spmm24_resnet50(quick: bool = False, device=None) -> Dict:
    """The harness sweep (gemm, prune, 2:4) over ResNet-50."""
    dev = _build.resolve_device(device)
    _, summary = run_model_sweep(
        "resnet50", kernels=("gemm", "prune", "spmm24"),
        max_layers=8 if quick else None, device=dev, verbose=False)
    return {"config": 1, "backend": dev.type, **summary}


def _coo_crossovers(rows) -> Dict:
    """Per-shape crossover sparsity: where batched COO (kernel only, and
    with the conversion) first beats dense, interpolated linearly in
    log-speedup between adjacent sweep points. When no crossing is
    bracketed, the last two points fit log(speedup) against log(1 - sp)
    and are solved for a speedup of 1 (capped at 0.9999, marked
    ``"..._extrapolated"``)."""
    out = {}
    by_shape = {}
    for r in rows:
        by_shape.setdefault((r["m"], r["n"], r["k"], r["b"]), []).append(r)
    for key, rs in by_shape.items():
        rs.sort(key=lambda r: r["sparsity"])
        entry = {}
        for col in ("speedup_vs_dense", "speedup_vs_dense_incl_conv"):
            cross = None
            extrapolated = False
            for lo, hi in zip(rs, rs[1:]):
                a, b = lo.get(col), hi.get(col)
                if a is None or b is None or a != a or b != b:
                    continue
                if a <= 1.0 < b:
                    la, lb = math.log(max(a, 1e-12)), math.log(b)
                    frac = (0.0 - la) / (lb - la)
                    cross = (lo["sparsity"]
                             + frac * (hi["sparsity"] - lo["sparsity"]))
                    break
            if cross is None and rs and (rs[0].get(col) or 0) > 1.0:
                cross = rs[0]["sparsity"]  # already winning at the start
            if cross is None and len(rs) >= 2:
                lo, hi = rs[-2], rs[-1]
                a, b = lo.get(col), hi.get(col)
                if (a and b and a == a and b == b and 0 < a < b < 1.0
                        and hi["sparsity"] < 1.0):
                    xa = math.log(1.0 - lo["sparsity"])
                    xb = math.log(1.0 - hi["sparsity"])
                    ya, yb = math.log(a), math.log(b)
                    if yb != ya:
                        x1 = xb + (0.0 - yb) * (xb - xa) / (yb - ya)
                        cross = min(1.0 - math.exp(x1), 0.9999)
                        extrapolated = True
            entry[col] = round(cross, 4) if cross is not None else None
            if extrapolated:
                entry[col + "_extrapolated"] = True
        out["x".join(str(v) for v in key)] = entry
    return out


def config2_coo_resnet101(quick: bool = False, subset_stride: int = 1,
                          device=None) -> Dict:
    """Batched COO SpMM over the ResNet-101 layers, 50-99.5% sparsity.

    One sparse A shared by the batch (the reference's stride-0 strided
    batch). Per point: the dense GEMM (``dense_ms``: the repeated bf16 A
    times ``B[0]``, as the JAX config defines it), the gather/segment-sum
    oracle (``coo_xla_ms``, ``spmm_coo`` in batch chunks of 4), kernel K6
    on pre-packed planes and their pre-built layout (``coo_seg_ms``), the
    host-side dense->COO build
    (``conversion_ms``, median of three), nonzeros per second and both
    speedups; per shape the crossover sparsity. The port has one segmented
    formulation, so ``coo_seg_slices_ms`` is NaN.
    """
    from ..ops.coo import coo_from_dense, coo_layout, pack_coo, spmm_coo, \
        spmm_coo_segmented
    from ..ops.gemm import batched_gemm
    from ..ops.prune import prune_threshold

    dev = _build.resolve_device(device)
    shapes = sorted(set(resnet_conv_shapes("resnet101")))
    if quick:
        shapes = shapes[:3]
    elif subset_stride > 1:
        shapes = shapes[::subset_stride]
    sweeps = (0.5, 0.7, 0.9, 0.95, 0.99, 0.995)
    rows = []
    for s in shapes:
        gen = torch.Generator(device=dev).manual_seed(0)
        a = torch.randn((s.m, s.k), generator=gen, device=dev)
        bm = torch.randn((s.b, s.k, s.n), generator=gen,
                         device=dev).to(torch.bfloat16)
        ad = a.to(torch.bfloat16)[None].repeat(s.b, 1, 1)
        t_dense = time_kernel(
            lambda x, y: batched_gemm(x, y, out_dtype=torch.bfloat16),
            (ad, bm[0]), iters=4, reps=3)
        del ad
        a_abs = np.abs(a.cpu().numpy())
        for sp in sweeps:
            thr = float(np.quantile(a_abs, sp))
            ap, _ = prune_threshold(a, thr)
            apn = ap.cpu().numpy()
            # Quantile ties can leave more nonzeros than the nominal
            # count: pad to whichever is larger.
            nnz = max(int(s.m * s.k * (1 - sp)), int(np.count_nonzero(apn)))
            conv_samples = []
            for _ in range(3):  # host-side build, one shared A
                t0 = time.perf_counter()
                coo = coo_from_dense(apn, nnz=nnz, device=dev)
                conv_samples.append(time.perf_counter() - t0)
            conv_ms = sorted(conv_samples)[1] * 1e3
            t = time_kernel(lambda c, y: spmm_coo(c, y, batch_chunk=4),
                            (coo, bm), iters=4, reps=3)
            packed = pack_coo(coo)
            # K6's layout is part of the format build, as the packing is
            lay = coo_layout(*packed, k=s.k)
            t_seg = time_kernel(
                lambda y: spmm_coo_segmented(
                    coo, y, packed=packed, gather="matmul", layout=lay),
                (bm,), iters=4, reps=3)
            sl_ms = float("nan")
            best = min(x for x in (t.ms, t_seg.ms, sl_ms) if x == x)
            rows.append({
                "m": s.m, "n": s.n, "k": s.k, "b": s.b, "sparsity": sp,
                "dense_ms": t_dense.ms, "coo_xla_ms": t.ms,
                "coo_seg_ms": t_seg.ms, "coo_seg_slices_ms": sl_ms,
                # nonzeros of the shared A touched across the batch
                "nnz_per_s": nnz * s.b / (best * 1e-3),
                "conversion_ms": conv_ms,
                "speedup_vs_dense": t_dense.ms / best,
                # one conversion charged to one batched call
                "speedup_vs_dense_incl_conv": t_dense.ms / (best + conv_ms),
            })
            del coo, packed, lay
    wins = [r for r in rows if r["speedup_vs_dense"] > 1.0]
    return {
        "config": 2,
        "backend": dev.type,
        "points": len(rows),
        "shape_subset_stride": subset_stride,
        "crossover_by_shape": _coo_crossovers(rows),
        "coo_xla_ms_geomean": _geomean([r["coo_xla_ms"] for r in rows]),
        "coo_seg_ms_geomean": _geomean([r["coo_seg_ms"] for r in rows]),
        "dense_ms_geomean": _geomean([r["dense_ms"] for r in rows]),
        "speedup_vs_dense_geomean": _geomean(
            [r["speedup_vs_dense"] for r in rows]),
        "nnz_per_s_geomean": _geomean([r["nnz_per_s"] for r in rows]),
        "points_beating_dense": len(wins),
        "rows": rows,
    }


def config3_fused_pipeline_resnet152(quick: bool = False,
                                     device=None) -> Dict:
    """The plan's prune, compress and matmul phases on ResNet-152 shapes
    (metadata reuse across the batch)."""
    from ..plan import SpmmaConfig, get_plan

    dev = _build.resolve_device(device)
    shapes = sorted(set(resnet_conv_shapes("resnet152")))
    if quick:
        shapes = shapes[:3]
    rows = []
    for s in shapes:
        gen = torch.Generator(device=dev).manual_seed(0)
        a = torch.randn((s.b, s.m, s.k), generator=gen,
                        device=dev).to(torch.bfloat16)
        bm = torch.randn((s.k, s.n), generator=gen,
                         device=dev).to(torch.bfloat16)
        plan = get_plan(SpmmaConfig(m=s.m, n=s.n, k=s.k, batch=s.b,
                                    out_dtype="bfloat16"))
        _, times = plan.timed(a, bm, iters=4, reps=3)
        rows.append(times)
    return {
        "config": 3,
        "backend": dev.type,
        "layers": len(rows),
        "prune_ms_geomean": _geomean([t["prune"].ms for t in rows]),
        "compress_ms_geomean": _geomean([t["compress"].ms for t in rows]),
        "mul_ms_geomean": _geomean([t["mul"].ms for t in rows]),
    }


RANKS = 8  # config 4's largest mesh: the JAX tests' 8-device CPU mesh


def _config4_point(p: int, cards: int, bsz: int, m: int, n: int, k: int,
                   ring_ms: float, ideal_ms: float) -> Dict:
    nnz = bsz * m * (k // 2)
    return {
        "devices": p,
        "cards": cards,
        "batch": bsz,
        "ring_ms": ring_ms,
        "ideal_ms": ideal_ms,
        "comm_efficiency": ideal_ms / ring_ms if ring_ms > 0
        else float("nan"),
        "nnz_per_s_per_device": nnz / (ring_ms * 1e-3) / p,
        # what the ring moves per rank: P-1 forwards of its [k/P, n] f32
        # B shard
        "halo_bytes_per_device": (p - 1) * (k // p) * n * 4,
    }


def config4_row_partitioned_scaling(quick: bool = False,
                                    device=None) -> Dict:
    """Row-partitioned batched 2:4 SpMM over P = 1, 2, 4, 8 ranks with the
    ring exchange of B shards (weak scaling: the batch grows with P), and
    kernel K7's two rings held against the ppermute ring.

    On the card the ranks go round-robin over ``torch.cuda.device_count()``
    cards; with one card they share it (each rank with its own streams).
    ``comm_efficiency`` is ``ideal_ms / ring_ms`` at the same P, where the
    ideal is ``spmm_24_row_sharded`` (B replicated, no exchange, the same
    local K3 work). With ``device="cpu"`` eight CPU ranks run the plain
    versions one after another.
    """
    from ..ops.prune import prune_nm
    from ..ops.sparse24 import compress_24
    from ..parallel.mesh import make_mesh
    from ..parallel.ring_kernel import spmm_24_ring_explicit, \
        spmm_24_ring_tiled
    from ..parallel.spmm_sharded import spmm_24_ring, spmm_24_row_sharded

    dev = _build.resolve_device(device)
    if dev.type == "cuda":
        cards = torch.cuda.device_count()
        ranks = [torch.device("cuda", r % cards) for r in range(RANKS)]
    else:
        ranks = [dev] * RANKS
    bsz0, m, n, k = (2, 256, 128, 512) if quick else (4, 1024, 256, 2048)

    def operands(p, seed, rows_shape):
        gen = torch.Generator(device=dev).manual_seed(seed)
        a = torch.randn(rows_shape, generator=gen, device=dev)
        gen.manual_seed(1)
        bm = torch.randn((k, n), generator=gen, device=dev)
        mesh = make_mesh((p,), ("model",), devices=ranks[:p])
        return compress_24(prune_nm(a, 2, 4)[0]), bm, mesh

    def run_p(p):
        bsz = bsz0 * p
        s, bm, mesh = operands(p, 0, (bsz, m, k))
        t_ring = time_kernel(
            lambda ss, y: spmm_24_ring(ss, y, mesh, "model"), (s, bm),
            iters=4, reps=3)
        t_ideal = time_kernel(
            lambda ss, y: spmm_24_row_sharded(ss, y, mesh, "model"),
            (s, bm), iters=4, reps=3)
        return _config4_point(p, len(set(ranks[:p])), bsz, m, n, k,
                              t_ring.ms, t_ideal.ms)

    points = []
    p = 1
    while p <= RANKS:
        points.append(run_p(p))
        p *= 2
    base = points[0]["nnz_per_s_per_device"]
    for pt in points:
        pt["weak_scaling_throughput_ratio"] = (
            pt["nnz_per_s_per_device"] / base)
    p2 = next((pt for pt in points if pt["devices"] > 1), None)
    shared = p2 is not None and p2["cards"] < p2["devices"]
    emulated_headline = {
        "what": "ring exchange overhead against the zero-communication "
                "ideal (B replicated) at the lowest multi-rank point, "
                + ("ranks sharing cards: copies on the card, events and "
                   "launches, not NVLink" if shared else
                   "one rank per card: peer copies between cards"),
        "devices": p2["devices"],
        "comm_efficiency": min(p2["comm_efficiency"], 1.0),
        "comm_efficiency_raw": p2["comm_efficiency"],
        "note": "raw > 1 means the ring's P smaller local products ran "
                "faster than the ideal's; the clamped value is the "
                "conservative bound",
    } if p2 else None

    # K7's two routes against the ppermute ring at P = min(4, ranks).
    pv = min(4, RANKS)
    s, bm, mesh = operands(pv, 0, (bsz0 * pv, m, k))
    want = spmm_24_ring(s, bm, mesh, "model", out_dtype=torch.float32)
    got = spmm_24_ring_explicit(s, bm, mesh, "model",
                                out_dtype=torch.float32)
    err = float((got - want).abs().max() / (want.abs().max() + 1e-9))
    mt = 128
    s_t, bm, mesh = operands(pv, 2, (mt * pv * 2, k))
    want_t = spmm_24_ring(s_t, bm, mesh, "model", out_dtype=torch.float32)
    got_t = spmm_24_ring_tiled(s_t, bm, mesh, "model",
                               out_dtype=torch.float32, m_tile=mt)
    err_t = float((got_t - want_t).abs().max()
                  / (want_t.abs().max() + 1e-9))
    return {
        "config": 4,
        "backend": dev.type,
        "shape": {"b_per_device": bsz0, "m": m, "n": n, "k": k},
        "emulated_headline": emulated_headline,
        "points": points,
        "explicit_overlap_ring": {
            "kernel": "parallel.ring_kernel.spmm_24_ring_explicit (K7, "
                      "csrc/ring24.cu; double-buffered copies on comm "
                      "streams under event credits)",
            "devices": pv,
            "max_rel_err_vs_ppermute": err,
            # no sanitizer checks cross-stream order on the card; the card
            # tests delay one rank instead (test_ring_credit_protocol)
            "race_detection": False,
        },
        "tiled_ring": {
            "kernel": "parallel.ring_kernel.spmm_24_ring_tiled (K7 per "
                      "m-tile, a whole ring per tile)",
            "devices": pv,
            "m_tiles_per_shard": 2,
            "max_rel_err_vs_ppermute": err_t,
        },
        "note": "weak scaling (fixed work per rank), the ppermute ring at "
                "every P. Ranks go round-robin over the cards; ranks on one "
                "card share its SMs and memory, so ring_ms and ideal_ms "
                "grow with P there and comm_efficiency measures the "
                "exchange's copies, event waits and launches, not NVLink. "
                "With one rank per card ring_ms vs ideal_ms is the scaling "
                "efficiency and halo_bytes_per_device crosses NVLink",
    }


def plain_block(s, b: torch.Tensor, out_dtype) -> torch.Tensor:
    """The plain version of a ring on this rank's blocks: ``spmm_24`` on
    CPU copies of its planes (whole in k) and of the whole B, back on the
    planes' device."""
    import dataclasses

    from ..ops.sparse24 import spmm_24

    cpu = dataclasses.replace(s, values0=s.values0.cpu(),
                              values1=s.values1.cpu(), codes=s.codes.cpu())
    return spmm_24(cpu, b.cpu(), out_dtype=out_dtype).to(s.values0.device)


def config4_processes(quick: bool = False) -> Dict:
    """Config 4 with one rank per process: the ppermute ring and its
    zero-communication ideal at P = the world size of the running process
    group (:func:`~..parallel.mesh.init_distributed`), at the same full size
    and the same weak scaling as :func:`config4_row_partitioned_scaling`.
    Each rank makes the whole A from the same seed, keeps its block of
    ``bsz0`` batch elements (pruned and compressed there) and its k-shard
    of B, and times the ring on its blocks without gathering C; ``ring_ms``
    and ``ideal_ms`` are the slowest rank's. K7's two rings are held to the
    ppermute ring on the same blocks, and the ppermute ring to its plain
    version (:func:`plain_block`), each the largest error over the ranks.
    Every process must call it."""
    import torch.distributed as dist

    from ..ops.prune import prune_nm
    from ..ops.sparse24 import compress_24
    from ..parallel.mesh import make_mesh, shard
    from ..parallel.ring_kernel import spmm_24_ring_explicit, \
        spmm_24_ring_tiled
    from ..parallel.spmm_sharded import (pad_rows, spmm_24_ring,
                                         spmm_24_row_sharded)

    mesh = make_mesh(None, ("model",))
    if not mesh.is_process_mesh:
        raise RuntimeError("config4_processes needs a running process group "
                           "(torch.distributed.run)")
    p, dev = mesh.shape["model"], mesh.device
    bsz0, m, n, k = (2, 256, 128, 512) if quick else (4, 1024, 256, 2048)

    def operands(seed, rows_shape):
        gen = torch.Generator(device=dev).manual_seed(seed)
        a = torch.randn(rows_shape, generator=gen, device=dev)
        gen.manual_seed(1)
        bm = torch.randn((k, n), generator=gen, device=dev)
        # this rank's rows: compressed, they are its block of planes
        a = shard(a, ("model",) + (None,) * (a.ndim - 1), mesh)[0]
        blk = compress_24(prune_nm(a, 2, 4)[0])
        bp = pad_rows(bm, 4 * blk.values0.shape[0])
        return blk, bm, shard(bp, ("model", None), mesh)[0]

    def slowest(x: float) -> float:
        t = torch.tensor([x], dtype=torch.float64, device=dev)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return float(t)

    def max_rel(got, want) -> float:
        t = torch.stack([(got - want).abs().max(), want.abs().max()]).to(
            torch.float64)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return float(t[0] / (t[1] + 1e-9))

    bsz = bsz0 * p
    s, bm, b_shard = operands(0, (bsz, m, k))
    t_ring = time_kernel(
        lambda ss, y: spmm_24_ring(ss, y, mesh, "model"), (s, b_shard),
        iters=4, reps=3)
    t_ideal = time_kernel(
        lambda ss, y: spmm_24_row_sharded(ss, y, mesh, "model"), (s, bm),
        iters=4, reps=3)
    point = _config4_point(p, len({str(d) for d in mesh.devices.flat}),
                           bsz, m, n, k, slowest(t_ring.ms),
                           slowest(t_ideal.ms))
    want = spmm_24_ring(s, b_shard, mesh, "model", out_dtype=torch.float32)
    err_plain = max_rel(want, plain_block(s, bm, torch.float32))
    got = spmm_24_ring_explicit(s, b_shard, mesh, "model",
                                out_dtype=torch.float32)
    err = max_rel(got, want)
    mt = 128
    s_t, _, b_t = operands(2, (mt * p * 2, k))
    want_t = spmm_24_ring(s_t, b_t, mesh, "model", out_dtype=torch.float32)
    got_t = spmm_24_ring_tiled(s_t, b_t, mesh, "model",
                               out_dtype=torch.float32, m_tile=mt)
    err_t = max_rel(got_t, want_t)
    return {
        "config": 4,
        "backend": dist.get_backend(),
        "shape": {"b_per_device": bsz0, "m": m, "n": n, "k": k},
        "points": [point],
        "ppermute_ring": {
            "kernel": "parallel.spmm_sharded.spmm_24_ring (K3 per step, "
                      "batch_isend_irecv between processes)",
            "max_rel_err_vs_plain": err_plain,
        },
        "explicit_overlap_ring": {
            "kernel": "parallel.ring_kernel.spmm_24_ring_explicit (K7, "
                      "csrc/ring24.cu; two comm slots per process, "
                      "batch_isend_irecv under slot-free events)",
            "devices": p,
            "max_rel_err_vs_ppermute": err,
        },
        "tiled_ring": {
            "kernel": "parallel.ring_kernel.spmm_24_ring_tiled (K7 per "
                      "m-tile, a whole ring per tile)",
            "devices": p,
            "m_tiles_per_shard": 2,
            "max_rel_err_vs_ppermute": err_t,
        },
        "note": "one rank per process (torch.distributed.run), weak "
                "scaling at P = the world size; ring_ms and ideal_ms are "
                "the slowest rank's, C stays sharded",
    }


RUNNERS = {
    0: config0_threshold_gemm_cpu,
    1: config1_spmm24_resnet50,
    2: config2_coo_resnet101,
    3: config3_fused_pipeline_resnet152,
    4: config4_row_partitioned_scaling,
}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("config", type=int, choices=sorted(RUNNERS))
    p.add_argument("--quick", action="store_true")
    p.add_argument("--cpu", action="store_true",
                   help="run the plain versions on the CPU (times mean "
                        "nothing on a device)")
    p.add_argument("--processes", action="store_true",
                   help="config 4 with one rank per process (run under "
                        "torch.distributed.run; NCCL ranks on cards, gloo "
                        "ranks with --cpu)")
    args = p.parse_args(argv)
    if args.processes:
        import torch.distributed as dist

        from ..parallel.mesh import start_processes

        if args.config != 4:
            p.error("--processes runs config 4 only")
        start_processes(cpu=args.cpu)
        result = config4_processes(quick=args.quick)
        if dist.get_rank() == 0:
            print(json.dumps(result, default=float), flush=True)
        dist.destroy_process_group()
        return 0
    kw = {"device": "cpu"} if args.cpu else {}
    result = RUNNERS[args.config](quick=args.quick, **kw)
    print(json.dumps(result, default=float), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
