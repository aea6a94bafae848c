#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (``sparsifyme_tpu_torch``).

Usage: python3 chip_smoke.py        (needs one CUDA card; builds the
kernels from ``sparsifyme_tpu_torch/csrc`` with nvcc at first use)

Phases, each raising on failure:
  1. print the card (nvidia-smi name and power limit, torch's name);
  2. build the five Hopper kernels (one nvcc per source, in parallel);
  3. hold every kernel route against its plain PyTorch version on the card,
     at full ResNet-50 width (b=32): K1 prune, K2 compress and the fused
     prune+compress route (K2 on dense input) exactly equal; K3 2:4 SpMM,
     its fold=2 route, K4 Blocked-ELL gather SpMM and K5 Blocked-ELL expand
     SpMM within a relative error of 2e-2 in bf16 and 1e-4 in f32; plus the
     2:4, ELL and plan pipelines on the card against the same pipelines on
     the CPU at a small size;
  4. the bench path: ``run_model_sweep("resnet50")`` over all 49 layers,
     with every launch counter set to 0 just before and read just after;
     prints the sweep's JSON line and fails unless every kernel of the
     sweep launched (the fused route and K5 included), and the speedup
     geomeans and ``fused_frac_sol_geomean`` are finite and positive;
  5. the plan path: ``spmma(a, b, timed=True)`` on each of the 17 unique
     ResNet-50 shapes (b=32, bf16), counters set to 0 just before and read
     just after; every phase time > 0, ``plan(a, b)`` exactly equal to
     ``plan.matmul(plan.compress(plan.prune(a)), b)``, and the fold=2 route
     ``spmm_24(prune_compress_24(a, fold=2), b)`` within 2e-2 of the fold=1
     route where ``k4 <= 256``;
  6. one ``{"kernels": [...]}`` line: each route's time at a main-path
     shape beside its plain version, a PyTorch library call computing the
     same function (where one exists) and its bound, with its launches on
     the two paths and its error against the plain version there (the
     K5 entry also times K4 on the same operand, ``gather_ms``);
  7. the card line again, then ``{"ok": true, "device": {...}}`` last.
"""

import json
import math
import subprocess
import sys
import time

import torch

SHAPES = [(12544, 64, 147), (196, 512, 4608), (3136, 128, 1152)]  # m, n, k
EXPAND_SHAPES = SHAPES + [(12544, 256, 64)]
FOLD_SHAPES = [(12544, 64, 147), (12544, 64, 576)]
ALL_SHAPES = list(dict.fromkeys(SHAPES + EXPAND_SHAPES + FOLD_SHAPES))
BATCH = 32
NAMED = (3136, 128, 1152)  # main-path shape of the kernels line
NAMED_FOLD = (12544, 64, 576)  # fold needs k4 <= 256
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
REPLACES = {
    "prune_nm": "sparsifyme_tpu/ops/kernels/prune_kernel.py:81 "
                "prune_nm_pallas",
    "compress_24": "sparsifyme_tpu/ops/kernels/prune_kernel.py:285 "
                   "compress_24_pallas",
    "prune_compress_24": "sparsifyme_tpu/ops/kernels/prune_kernel.py:577 "
                         "prune_compress_24_pallas",
    "spmm_24": "sparsifyme_tpu/ops/kernels/spmm24_kernel.py:703 "
               "spmm24_pallas (+ :513 spmm24_pallas_fp)",
    "spmm_24_fold": "sparsifyme_tpu/ops/kernels/spmm24_kernel.py:925 "
                    "spmm24_fold_pallas",
    "spmm_ell": "sparsifyme_tpu/ops/kernels/ell_kernel.py:206 "
                "ell_spmm_pallas",
    "spmm_ell_expand": "sparsifyme_tpu/ops/kernels/ell_kernel.py:448 "
                       "ell_expand_spmm_pallas",
}
SOURCES = {
    "prune_nm": "sparsifyme_tpu_torch/csrc/prune_nm.cu",
    "compress_24": "sparsifyme_tpu_torch/csrc/compress24.cu",
    "prune_compress_24": "sparsifyme_tpu_torch/csrc/compress24.cu",
    "spmm_24": "sparsifyme_tpu_torch/csrc/spmm24.cu",
    "spmm_24_fold": "sparsifyme_tpu_torch/csrc/spmm24.cu",
    "spmm_ell": "sparsifyme_tpu_torch/csrc/ell_spmm.cu",
    "spmm_ell_expand": "sparsifyme_tpu_torch/csrc/ell_expand.cu",
}
SWEEP_ROUTES = ("prune_nm", "compress_24", "prune_compress_24", "spmm_24",
                "spmm_ell", "spmm_ell_expand")
PLAN_ROUTES = ("prune_nm", "compress_24", "prune_compress_24", "spmm_24",
               "spmm_24_fold")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


def errors(out: torch.Tensor, ref: torch.Tensor):
    """``(max absolute error, max absolute error / max |ref|)``."""
    out, ref = out.float(), ref.float()
    if out.shape != ref.shape or not torch.isfinite(out).all():
        raise AssertionError(f"bad output {tuple(out.shape)} vs "
                             f"{tuple(ref.shape)}")
    abs_err = float((out - ref).abs().max())
    return abs_err, abs_err / max(float(ref.abs().max()), 1e-30)


def close(name, out, ref, dtype, what):
    a, e = errors(out, ref)
    tol = TOL[dtype]
    print(f"  {name:17s} {what:44s} rel_err={e:.3e} (tol {tol:g})",
          flush=True)
    if not e <= tol:
        raise AssertionError(f"{name} {what}: rel err {e} > {tol}")
    return a, e


def exact(name, outs, refs, what):
    for o, r in zip(outs, refs):
        if o.shape != r.shape or o.dtype != r.dtype or not torch.equal(o, r):
            raise AssertionError(f"{name} {what}: not exactly equal")
    print(f"  {name:17s} {what:44s} exactly equal", flush=True)


def harness_ell(a, k):
    """The harness's ELL operand for a batch ``a [b, m, k]``: block_k by
    k, fold_first by m; returns ``(e, kp, bkb, fold_first)``."""
    from sparsifyme_tpu_torch.bench.harness import build_ell_operand

    b_, m, _ = a.shape
    bkb = 32 if k < 512 else (64 if k < 1536 else 128)
    ff = m % 128 != 0 and (m * b_) % 128 == 0
    e, kp = build_ell_operand(a, block_size=128, block_k=bkb, fold_first=ff)
    return e, kp, bkb, ff


def case_tag(case) -> str:
    return " ".join(f"{k}={v}" for k, v in case.items()) or "plain"


def phase_kernels() -> None:
    from sparsifyme_tpu_torch.ops.ell import ell_pack, ell_values_kmajor
    from sparsifyme_tpu_torch.ops.kernels import (ell_kernel, prune_kernel,
                                                  spmm24_kernel)
    from sparsifyme_tpu_torch.ops.sparse24 import (pack_codes_fp,
                                                   prune_compress_24)

    counts0 = launch_counts()
    gen = torch.Generator(device="cuda").manual_seed(1234)
    for (m, n, k) in ALL_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            tag = f"{m}x{n}x{k}x{BATCH} {str(dtype)[6:]}"
            a = torch.randn((BATCH, m, k), generator=gen,
                            device="cuda").to(dtype)
            b = torch.randn((k, n), generator=gen, device="cuda").to(dtype)
            cases = [dict(transpose_out=False), dict(transpose_out=True),
                     dict(transpose_out=False, alpha=0.5, beta=0.25,
                          c=True)]
            if (m, n, k) in SHAPES:
                pw, pm = prune_kernel.prune_nm_cuda(a, 2, 4)
                exact("prune_nm", (pw, pm),
                      prune_kernel.prune_nm_plain(a, 2, 4), tag)
                w2 = pw.reshape(-1, k)
                planes = prune_kernel.compress_24_cuda(w2)
                exact("compress_24", planes,
                      prune_kernel.compress_24_plain(w2), tag)
                dense = a.reshape(-1, k)
                fused = prune_kernel.prune_compress_24_cuda(dense)
                exact("prune_compress_24", fused,
                      prune_kernel.prune_compress_24_plain(dense),
                      f"{tag} (dense in)")
                exact("prune_compress_24", fused, planes,
                      f"{tag} (= compress of pruned)")
                v0, v1, codes = planes
                sp_cases = list(cases)
                if codes.shape[0] * 4 <= 1024:  # where pack_codes_fp applies
                    sp_cases.append(dict(transpose_out=True,
                                         packed_codes=True))
                for case in sp_cases:
                    kw = dict(case)
                    if kw.pop("c", False):
                        kw["c"] = torch.randn((BATCH * m, n), generator=gen,
                                              device="cuda")
                    cc = (pack_codes_fp(codes) if kw.get("packed_codes")
                          else codes)
                    args = (v0, v1, cc, b)
                    kw.update(k_logical=k, out_dtype=dtype)
                    close("spmm_24", spmm24_kernel.spmm24_cuda(*args, **kw),
                          spmm24_kernel.spmm24_plain(*args, **kw), dtype,
                          f"{tag} {case_tag(case)}")
                del pw, pm, planes, fused, v0, v1, codes
            if (m, n, k) in EXPAND_SHAPES:
                e, kp, bkb, ff = harness_ell(a, k)
                dense = torch.nn.functional.pad(
                    a.reshape(BATCH * m, k) if ff else a,
                    (0, kp - k, 0, (-(BATCH * m if ff else m)) % 128))
                exact("ell_pack", (e.values.cpu(),),
                      (ell_pack(dense.cpu(), e.col_indices.cpu(), 128,
                                bkb),), f"{tag} (card vs CPU)")
                bp = torch.nn.functional.pad(b, (0, 0, 0, kp - k))
                vals = e.values.reshape(-1, e.values.shape[-1])
                cols = e.col_indices.reshape(-1, e.col_indices.shape[-1])
                kwe = dict(block_size=128, block_k=bkb, out_dtype=dtype)
                for case in cases if (m, n, k) in SHAPES else ():
                    kw = dict(case)
                    if kw.pop("c", False):
                        kw["c"] = torch.randn((vals.shape[0], n),
                                              generator=gen, device="cuda")
                    kw.update(kwe)
                    close("spmm_ell",
                          ell_kernel.ell_spmm_cuda(vals, cols, bp, **kw),
                          ell_kernel.ell_spmm_plain(vals, cols, bp, **kw),
                          dtype, f"{tag} bk={bkb} {case_tag(case)}")
                vkm = ell_values_kmajor(e)
                for tout in (False, True):
                    kw = dict(kwe, transpose_out=tout)
                    close("spmm_ell_expand",
                          ell_kernel.ell_expand_spmm_cuda(vkm, cols, bp,
                                                          **kw),
                          ell_kernel.ell_expand_spmm_plain(vkm, cols, bp,
                                                           **kw),
                          dtype, f"{tag} bk={bkb} transpose_out={tout}")
                del e, dense, vals, cols, vkm
            if (m, n, k) in FOLD_SHAPES:
                s = prune_compress_24(a, fold=2)
                for case in cases[::2]:  # row-major C only
                    kw = dict(case)
                    kw.pop("transpose_out")
                    if kw.pop("c", False):
                        kw["c"] = torch.randn((BATCH * m, n), generator=gen,
                                              device="cuda")
                    kw.update(k_logical=k, out_dtype=dtype)
                    args = (s.values0, s.values1, s.codes, b)
                    close("spmm_24_fold",
                          spmm24_kernel.spmm24_fold_cuda(*args, **kw),
                          spmm24_kernel.spmm24_fold_plain(*args, **kw),
                          dtype, f"{tag} {case_tag(case)}")
                del s
            del a, b
            torch.cuda.empty_cache()
    counts = launch_counts()
    for name in REPLACES:
        if counts[name] <= counts0[name]:
            raise AssertionError(f"{name}: launch counter did not move")


def phase_pipeline() -> None:
    """The public 2:4, ELL and plan pipelines on the card against the same
    pipelines on the CPU (plain versions), at a small size."""
    import sparsifyme_tpu_torch as sp

    gen = torch.Generator().manual_seed(7)
    a = torch.randn((2, 256, 147), generator=gen).to(torch.bfloat16)
    b = torch.randn((147, 64), generator=gen).to(torch.bfloat16)
    outs = {}
    for dev in ("cpu", "cuda"):
        ad, bd = a.to(dev), b.to(dev)
        s = sp.compress_24(sp.prune_24(ad)[0])
        e = sp.ell_from_dense(torch.nn.functional.pad(ad, (0, 13)), 128, 3,
                              32)
        bp = torch.nn.functional.pad(bd, (0, 0, 0, 13))
        outs[dev] = (sp.spmm_24(s, bd), sp.spmm_ell(e, bp),
                     sp.spmm_ell_expand(e, bp), sp.spmma(ad, bd),
                     sp.spmm_24(sp.prune_compress_24(ad, fold=2), bd))
    for what, o_gpu, o_cpu in zip(
            ("2:4 pipeline", "ELL pipeline", "ELL expand", "spmma",
             "2:4 fold=2"), outs["cuda"], outs["cpu"]):
        err = errors(o_gpu.cpu(), o_cpu)[1]
        print(f"  {what:17s} card vs CPU rel_err={err:.3e}", flush=True)
        if o_gpu.shape != (2, 256, 64) or not err <= 2e-2:
            raise AssertionError(f"{what}: card disagrees with CPU")


def _wrappers():
    from sparsifyme_tpu_torch.ops.kernels import (ell_kernel, prune_kernel,
                                                  spmm24_kernel)
    return {
        "prune_nm": prune_kernel.prune_nm_cuda,
        "compress_24": prune_kernel.compress_24_cuda,
        "prune_compress_24": prune_kernel.prune_compress_24_cuda,
        "spmm_24": spmm24_kernel.spmm24_cuda,
        "spmm_24_fold": spmm24_kernel.spmm24_fold_cuda,
        "spmm_ell": ell_kernel.ell_spmm_cuda,
        "spmm_ell_expand": ell_kernel.ell_expand_spmm_cuda,
    }


def launch_counts():
    return {name: fn.launches for name, fn in _wrappers().items()}


def reset_counts() -> None:
    for fn in _wrappers().values():
        fn.launches = 0


def check_launched(counts, routes, path):
    for name in routes:
        if counts[name] <= 0:
            raise AssertionError(f"{name}: no launch on the {path} path")


def phase_main_path():
    """The 49-layer sweep; also returns the expand kernel's launches per
    unique shape (to pick the shape of its kernels-line entry)."""
    from sparsifyme_tpu_torch.bench import harness
    from sparsifyme_tpu_torch.ops.kernels import ell_kernel

    per_shape = {}
    bench_shape = harness.bench_shape

    def counted(shape, **kw):
        n0 = ell_kernel.ell_expand_spmm_cuda.launches
        out = bench_shape(shape, **kw)
        per_shape[tuple(shape)] = ell_kernel.ell_expand_spmm_cuda.launches - n0
        return out

    harness.bench_shape = counted
    try:
        reset_counts()
        t0 = time.perf_counter()
        results, summary = harness.run_model_sweep("resnet50", iters=10,
                                                   reps=3, verbose=True)
        counts = launch_counts()
    finally:
        harness.bench_shape = bench_shape
    print(f"bench path: {len(results)} layers in "
          f"{time.perf_counter() - t0:.1f} s; launches {counts}", flush=True)
    if len(results) != 49:
        raise AssertionError(f"expected 49 layers, got {len(results)}")
    check_launched(counts, SWEEP_ROUTES, "bench")
    print(json.dumps(harness.headline("resnet50", summary)), flush=True)
    for key in ("spmm24_speedup_geomean", "ell_speedup_geomean",
                "best_sparse_speedup_geomean", "fused_frac_sol_geomean"):
        v = summary[key]
        if not (math.isfinite(v) and v > 0):
            raise AssertionError(f"{key} = {v}")
    return counts, per_shape


def phase_plan_path():
    """spmma on the 17 unique ResNet-50 shapes, and the fold=2 route."""
    from sparsifyme_tpu_torch import (SpmmaConfig, get_plan,
                                      prune_compress_24, spmm_24, spmma)
    from sparsifyme_tpu_torch.models.resnet_shapes import resnet_conv_shapes

    shapes = list(dict.fromkeys(resnet_conv_shapes("resnet50")))
    if len(shapes) != 17:
        raise AssertionError(f"expected 17 unique shapes, got {len(shapes)}")
    gen = torch.Generator(device="cuda").manual_seed(5)
    reset_counts()
    t0 = time.perf_counter()
    folds = 0
    for sh in shapes:
        a = torch.randn((sh.b, sh.m, sh.k), generator=gen,
                        device="cuda").to(torch.bfloat16)
        b = torch.randn((sh.k, sh.n), generator=gen,
                        device="cuda").to(torch.bfloat16)
        out, times = spmma(a, b, timed=True)
        if tuple(out.shape) != (sh.b, sh.m, sh.n) or not torch.isfinite(
                out).all():
            raise AssertionError(f"spmma {sh}: bad output")
        if not all(t.ms > 0 for t in times.values()):
            raise AssertionError(f"spmma {sh}: phase times {times}")
        plan = get_plan(SpmmaConfig(m=sh.m, n=sh.n, k=sh.k, batch=sh.b))
        fused = plan(a, b)
        phased = plan.matmul(plan.compress(plan.prune(a)), b)
        if not torch.equal(fused, phased):
            raise AssertionError(f"plan {sh}: fused != phased")
        line = " ".join(f"{k}={t.ms:.4f}" for k, t in times.items())
        if -(-sh.k // 64) * 16 <= 256:
            ref = spmm_24(prune_compress_24(a), b)
            err = errors(spmm_24(prune_compress_24(a, fold=2), b), ref)[1]
            if not err <= 2e-2:
                raise AssertionError(f"fold=2 {sh}: rel err {err}")
            line += f" fold_rel_err={err:.3e}"
            folds += 1
        print(f"  plan {sh.m}x{sh.n}x{sh.k}x{sh.b}: {line} fused==phased",
              flush=True)
        del a, b, out, fused, phased
    counts = launch_counts()
    print(f"plan path: {len(shapes)} shapes ({folds} with fold=2) in "
          f"{time.perf_counter() - t0:.1f} s; launches {counts}", flush=True)
    check_launched(counts, PLAN_ROUTES, "plan")
    return counts


def _bound(flops, tflops, byts):
    from sparsifyme_tpu_torch.bench import roofline as rl
    ms = max(flops / (tflops * 1e12), byts / (rl.H100.hbm_gbps * 1e9)) * 1e3
    return ms, rl.bound_by(flops, tflops, byts)


def phase_kernel_line(sweep_counts, plan_counts, expand_per_shape) -> dict:
    from sparsifyme_tpu_torch.bench import roofline as rl
    from sparsifyme_tpu_torch.ops.ell import ell_to_dense, ell_values_kmajor
    from sparsifyme_tpu_torch.ops.kernels import (ell_kernel, prune_kernel,
                                                  spmm24_kernel)
    from sparsifyme_tpu_torch.ops.sparse24 import (decompress_24,
                                                   prune_compress_24)
    from sparsifyme_tpu_torch.utils.timing import time_kernel

    dt = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(99)
    specs = []

    def operands(m, n, k):
        a = torch.randn((BATCH, m, k), generator=gen, device="cuda").to(dt)
        b = torch.randn((k, n), generator=gen, device="cuda").to(dt)
        return a, b

    # prune, compress, fused, 2:4 SpMM and ELL gather at the named shape
    m, n, k = NAMED
    rows = m * BATCH
    a, b = operands(m, n, k)
    pw = prune_kernel.prune_nm_cuda(a)[0]
    w2 = pw.reshape(-1, k)
    v0, v1, codes = prune_kernel.compress_24_cuda(w2)
    e, kp, bkb, _ = harness_ell(a, k)
    vals = e.values.reshape(-1, e.values.shape[-1])
    cols = e.col_indices.reshape(-1, e.col_indices.shape[-1])
    bp = torch.nn.functional.pad(b, (0, 0, 0, kp - k))
    kw24 = dict(k_logical=k, out_dtype=dt)
    kwe = dict(block_size=128, block_k=bkb, out_dtype=dt)
    flops = 2.0 * rows * n * k
    tag = f"{m}x{n}x{k}x{BATCH} bf16"
    specs += [
        ("prune_nm", tag, prune_kernel.prune_nm_cuda,
         prune_kernel.prune_nm_plain, (a,), None,
         (rl.prune_sol_ms(m, k, BATCH), "bytes")),
        ("compress_24", tag, prune_kernel.compress_24_cuda,
         prune_kernel.compress_24_plain, (w2,), None,
         (rl.compress_sol_ms(m, k, BATCH), "bytes")),
        ("prune_compress_24", tag, prune_kernel.prune_compress_24_cuda,
         prune_kernel.prune_compress_24_plain, (a.reshape(-1, k),), None,
         (rl.fused_sol_ms(m, k, BATCH), "bytes")),
        ("spmm_24", tag,
         lambda *x: spmm24_kernel.spmm24_cuda(*x, **kw24),
         lambda *x: spmm24_kernel.spmm24_plain(*x, **kw24),
         (v0, v1, codes, b), (torch.matmul, (w2, b)),
         _bound(flops, rl.H100.sparse24_tflops,
                1.25 * rows * k + 2 * k * n + 2 * rows * n)),
        ("spmm_ell", f"{tag} bk={bkb}",
         lambda *x: ell_kernel.ell_spmm_cuda(*x, **kwe),
         lambda *x: ell_kernel.ell_spmm_plain(*x, **kwe),
         (vals, cols, bp),
         (torch.matmul, (ell_to_dense(e).reshape(-1, kp), bp)),
         _bound(flops / 2 * kp / k, rl.H100.dense_tflops,
                rows * kp + 2 * kp * n + 2 * rows * n)),
    ]

    # the fold=2 route at a main-path shape that fold accepts
    m, n, k = NAMED_FOLD
    rows = m * BATCH
    a, b = operands(m, n, k)
    s = prune_compress_24(a, fold=2)
    kwf = dict(k_logical=k, out_dtype=dt)
    specs.append((
        "spmm_24_fold", f"{m}x{n}x{k}x{BATCH} bf16",
        lambda *x: spmm24_kernel.spmm24_fold_cuda(*x, **kwf),
        lambda *x: spmm24_kernel.spmm24_fold_plain(*x, **kwf),
        (s.values0, s.values1, s.codes, b),
        (torch.matmul, (decompress_24(s).reshape(-1, k), b)),
        _bound(2.0 * rows * n * k, rl.H100.sparse24_tflops,
               1.25 * rows * k + 2 * k * n + 2 * rows * n)))

    # K5 at the k < 512 shape whose sweep launched it most
    m, n, k, _ = max((sh for sh, c in expand_per_shape.items() if c > 0),
                     key=lambda sh: (expand_per_shape[sh],
                                     sh[0] * sh[1] * sh[2]))
    a, b = operands(m, n, k)
    e, kp, bkb, _ = harness_ell(a, k)
    vkm = ell_values_kmajor(e)
    cols = e.col_indices.reshape(-1, e.col_indices.shape[-1])
    bp = torch.nn.functional.pad(b, (0, 0, 0, kp - k))
    live = int(ell_kernel.live_slots(cols, -(-kp // bkb)).sum())
    kwx = dict(block_size=128, block_k=bkb, out_dtype=dt)
    specs.append((
        "spmm_ell_expand", f"{m}x{n}x{k}x{BATCH} bf16 bk={bkb}",
        lambda *x: ell_kernel.ell_expand_spmm_cuda(*x, **kwx),
        lambda *x: ell_kernel.ell_expand_spmm_plain(*x, **kwx),
        (vkm, cols, bp),
        (torch.matmul, (ell_to_dense(e).reshape(-1, kp), bp)),
        _bound(2.0 * live * 128 * bkb * n, rl.H100.dense_tflops,
               2.0 * live * 128 * bkb + 4 * cols.numel() + 2 * kp * n
               + 2 * vkm.shape[1] * n)))

    out = []
    for name, shape, kern, plain, ops, lib, (bound, by) in specs:
        got, want = kern(*ops), plain(*ops)
        if name in ("prune_nm", "compress_24", "prune_compress_24"):
            exact(name, got, want, f"{shape} (kernels line)")
            abs_err = rel_err = 0.0
        else:
            abs_err, rel_err = close(name, got, want, dt,
                                     f"{shape} (kernels line)")
        del got, want
        ms = time_kernel(kern, ops, iters=20, reps=5).ms
        plain_ms = time_kernel(plain, ops, iters=3, reps=3).ms
        lib_ms = (time_kernel(lib[0], lib[1], iters=20, reps=5).ms
                  if lib else None)
        out.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "shape": shape,
            "launches": sweep_counts[name] + plan_counts[name],
            "launches_by_path": {"bench": sweep_counts[name],
                                 "plan": plan_counts[name]},
            "max_abs_err": abs_err, "max_err": rel_err,
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": by, "library_ms": lib_ms,
        })
    # K4 on K5's operand: the two ELL formulations side by side
    out[-1]["gather_ms"] = time_kernel(
        lambda *x: ell_kernel.ell_spmm_cuda(*x, **kwx),
        (e.values.reshape(-1, e.values.shape[-1]), cols, bp), iters=20,
        reps=5).ms
    return {"kernels": out}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a GPU only",
              file=sys.stderr)
        return 1
    import sparsifyme_tpu_torch  # noqa: F401  (fails outside the repo)
    from sparsifyme_tpu_torch import _build

    line = card_line()
    print(f"card: {line} | torch: {torch.cuda.get_device_name(0)} "
          f"x{torch.cuda.device_count()} | torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    _build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s into "
          f"{_build.build_dir()}", flush=True)
    print("kernels against their plain versions:", flush=True)
    phase_kernels()
    phase_pipeline()
    sweep_counts, expand_per_shape = phase_main_path()
    plan_counts = phase_plan_path()
    print(json.dumps(phase_kernel_line(sweep_counts, plan_counts,
                                       expand_per_shape)), flush=True)
    print(line, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
