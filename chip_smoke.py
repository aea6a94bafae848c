#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (``sparsifyme_tpu_torch``).

Usage: python3 chip_smoke.py        (needs one CUDA card; builds the
kernels from ``sparsifyme_tpu_torch/csrc`` with nvcc at first use)

Phases, each raising on failure:
  1. print the card (nvidia-smi name and power limit, torch's name);
  2. build the four Hopper kernels (one nvcc per source, in parallel);
  3. hold every kernel against its plain PyTorch version on the card, at
     full ResNet-50 width (b=32): K1 prune and K2 compress exactly equal,
     K3 2:4 SpMM and K4 Blocked-ELL SpMM within a relative error of 2e-2
     in bf16 and 1e-4 in f32; plus the 2:4 and ELL pipelines on the card
     against the same pipelines on the CPU at a small size;
  4. the main path: ``run_model_sweep("resnet50")`` over all 49 layers,
     with every launch counter set to 0 just before and read just after;
     prints the sweep's JSON line and fails unless every kernel launched
     and the speedup geomeans are finite and positive;
  5. one ``{"kernels": [...]}`` line: each kernel's time at a main-path
     shape beside its plain version, a PyTorch library call computing the
     same function (where one exists) and its bound;
  6. the card line again, then ``{"ok": true, "device": {...}}`` last.
"""

import json
import math
import subprocess
import sys
import time

import torch

SHAPES = [(12544, 64, 147), (196, 512, 4608), (3136, 128, 1152)]  # m, n, k
BATCH = 32
NAMED = (3136, 128, 1152)  # main-path shape of the kernels line
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
REPLACES = {
    "prune_nm": "sparsifyme_tpu/ops/kernels/prune_kernel.py:81 "
                "prune_nm_pallas",
    "compress_24": "sparsifyme_tpu/ops/kernels/prune_kernel.py:285 "
                   "compress_24_pallas",
    "spmm_24": "sparsifyme_tpu/ops/kernels/spmm24_kernel.py:703 "
               "spmm24_pallas (+ :513 spmm24_pallas_fp)",
    "spmm_ell": "sparsifyme_tpu/ops/kernels/ell_kernel.py:206 "
                "ell_spmm_pallas",
}
SOURCES = {
    "prune_nm": "sparsifyme_tpu_torch/csrc/prune_nm.cu",
    "compress_24": "sparsifyme_tpu_torch/csrc/compress24.cu",
    "spmm_24": "sparsifyme_tpu_torch/csrc/spmm24.cu",
    "spmm_ell": "sparsifyme_tpu_torch/csrc/ell_spmm.cu",
}


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


class Checks:
    """Kernel-vs-plain comparisons; keeps each kernel's worst absolute and
    relative errors at the shape of the kernels line (0 for the kernels
    that must be exactly equal)."""

    def __init__(self):
        self.named_abs = {name: 0.0 for name in REPLACES}
        self.named_rel = {name: 0.0 for name in REPLACES}

    def close(self, name, out, ref, dtype, what, named):
        a, e = errors(out, ref)
        tol = TOL[dtype]
        print(f"  {name:12s} {what:44s} rel_err={e:.3e} (tol {tol:g})",
              flush=True)
        if not e <= tol:
            raise AssertionError(f"{name} {what}: rel err {e} > {tol}")
        if named:
            self.named_abs[name] = max(self.named_abs[name], a)
            self.named_rel[name] = max(self.named_rel[name], e)

    def exact(self, name, outs, refs, what):
        for o, r in zip(outs, refs):
            if o.shape != r.shape or o.dtype != r.dtype or not torch.equal(
                    o, r):
                raise AssertionError(f"{name} {what}: not exactly equal")
        print(f"  {name:12s} {what:44s} exactly equal", flush=True)


def phase_kernels(checks: Checks) -> None:
    from sparsifyme_tpu_torch.bench.harness import build_ell_operand
    from sparsifyme_tpu_torch.ops.ell import ell_pack
    from sparsifyme_tpu_torch.ops.kernels import (ell_kernel, prune_kernel,
                                                  spmm24_kernel)
    from sparsifyme_tpu_torch.ops.sparse24 import pack_codes_fp

    counts0 = launch_counts()
    gen = torch.Generator(device="cuda").manual_seed(1234)
    for (m, n, k) in SHAPES:
        named = (m, n, k) == NAMED
        for dtype in (torch.bfloat16, torch.float32):
            tag = f"{m}x{n}x{k}x{BATCH} {str(dtype)[6:]}"
            a = torch.randn((BATCH, m, k), generator=gen,
                            device="cuda").to(dtype)
            b = torch.randn((k, n), generator=gen, device="cuda").to(dtype)
            pw, pm = prune_kernel.prune_nm_cuda(a, 2, 4)
            checks.exact("prune_nm", (pw, pm),
                         prune_kernel.prune_nm_plain(a, 2, 4), tag)
            planes = prune_kernel.compress_24_cuda(pw.reshape(-1, k))
            checks.exact("compress_24", planes,
                         prune_kernel.compress_24_plain(pw.reshape(-1, k)),
                         tag)
            v0, v1, codes = planes
            cases = [dict(transpose_out=False), dict(transpose_out=True),
                     dict(transpose_out=False, alpha=0.5, beta=0.25,
                          c=True)]
            if codes.shape[0] * 4 <= 1024:  # where pack_codes_fp applies
                cases.append(dict(transpose_out=True, packed_codes=True))
            for case in cases:
                kw = dict(case)
                if kw.pop("c", False):
                    kw["c"] = torch.randn((BATCH * m, n), generator=gen,
                                          device="cuda")
                cc = pack_codes_fp(codes) if kw.get("packed_codes") else codes
                args = (v0, v1, cc, b)
                kw.update(k_logical=k, out_dtype=dtype)
                checks.close("spmm_24", spmm24_kernel.spmm24_cuda(*args, **kw),
                             spmm24_kernel.spmm24_plain(*args, **kw), dtype,
                             f"{tag} {case_tag(case)}", named)
            bkb = 32 if k < 512 else (64 if k < 1536 else 128)
            ff = m % 128 != 0 and (m * BATCH) % 128 == 0
            e, kp = build_ell_operand(a, block_size=128, block_k=bkb,
                                      fold_first=ff)
            dense = torch.nn.functional.pad(
                a.reshape(BATCH * m, k) if ff else a,
                (0, kp - k, 0, (-(BATCH * m if ff else m)) % 128))
            checks.exact("ell_pack", (e.values.cpu(),),
                         (ell_pack(dense.cpu(), e.col_indices.cpu(), 128,
                                   bkb),), f"{tag} (card vs CPU)")
            bp = torch.nn.functional.pad(b, (0, 0, 0, kp - k))
            vals = e.values.reshape(-1, e.values.shape[-1])
            cols = e.col_indices.reshape(-1, e.col_indices.shape[-1])
            for case in cases[:3]:
                kw = dict(case)
                if kw.pop("c", False):
                    kw["c"] = torch.randn((vals.shape[0], n), generator=gen,
                                          device="cuda")
                kw.update(block_size=128, block_k=bkb, out_dtype=dtype)
                checks.close("spmm_ell",
                             ell_kernel.ell_spmm_cuda(vals, cols, bp, **kw),
                             ell_kernel.ell_spmm_plain(vals, cols, bp, **kw),
                             dtype, f"{tag} bk={bkb} {case_tag(case)}", named)
            del a, pw, pm, planes, v0, v1, codes, e, dense
            torch.cuda.empty_cache()
    counts = launch_counts()
    for name in REPLACES:
        if counts[name] <= counts0[name]:
            raise AssertionError(f"{name}: launch counter did not move")


def case_tag(case) -> str:
    return " ".join(f"{k}={v}" for k, v in case.items()) or "plain"


def phase_pipeline() -> None:
    """The public 2:4 and ELL pipelines on the card against the same
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
        outs[dev] = (sp.spmm_24(s, bd),
                     sp.spmm_ell(e, torch.nn.functional.pad(bd,
                                                            (0, 0, 0, 13))))
    for what, o_gpu, o_cpu in zip(("2:4 pipeline", "ELL pipeline"),
                                  outs["cuda"], outs["cpu"]):
        err = errors(o_gpu.cpu(), o_cpu)[1]
        print(f"  {what:12s} card vs CPU rel_err={err:.3e}", flush=True)
        if o_gpu.shape != (2, 256, 64) or not err <= 2e-2:
            raise AssertionError(f"{what}: card disagrees with CPU")


def launch_counts():
    from sparsifyme_tpu_torch.ops.kernels import (ell_kernel, prune_kernel,
                                                  spmm24_kernel)
    return {
        "prune_nm": prune_kernel.prune_nm_cuda.launches,
        "compress_24": prune_kernel.compress_24_cuda.launches,
        "spmm_24": spmm24_kernel.spmm24_cuda.launches,
        "spmm_ell": ell_kernel.ell_spmm_cuda.launches,
    }


def reset_counts() -> None:
    from sparsifyme_tpu_torch.ops.kernels import (ell_kernel, prune_kernel,
                                                  spmm24_kernel)
    prune_kernel.prune_nm_cuda.launches = 0
    prune_kernel.compress_24_cuda.launches = 0
    spmm24_kernel.spmm24_cuda.launches = 0
    ell_kernel.ell_spmm_cuda.launches = 0


def phase_main_path():
    from sparsifyme_tpu_torch.bench.harness import headline, run_model_sweep

    reset_counts()
    t0 = time.perf_counter()
    results, summary = run_model_sweep("resnet50", iters=10, reps=3,
                                       verbose=True)
    counts = launch_counts()
    print(f"main path: {len(results)} layers in "
          f"{time.perf_counter() - t0:.1f} s; launches {counts}", flush=True)
    if len(results) != 49:
        raise AssertionError(f"expected 49 layers, got {len(results)}")
    for name, c in counts.items():
        if c <= 0:
            raise AssertionError(f"{name}: no launch on the main path")
    print(json.dumps(headline("resnet50", summary)), flush=True)
    for key in ("spmm24_speedup_geomean", "ell_speedup_geomean",
                "best_sparse_speedup_geomean"):
        v = summary[key]
        if not (math.isfinite(v) and v > 0):
            raise AssertionError(f"{key} = {v}")
    return counts


def phase_kernel_line(checks: Checks, counts) -> dict:
    from sparsifyme_tpu_torch.bench import roofline as rl
    from sparsifyme_tpu_torch.bench.harness import build_ell_operand
    from sparsifyme_tpu_torch.ops.ell import ell_to_dense
    from sparsifyme_tpu_torch.ops.kernels import (ell_kernel, prune_kernel,
                                                  spmm24_kernel)
    from sparsifyme_tpu_torch.utils.timing import time_kernel

    m, n, k = NAMED
    rows = m * BATCH
    dt = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(99)
    a = torch.randn((BATCH, m, k), generator=gen, device="cuda").to(dt)
    b = torch.randn((k, n), generator=gen, device="cuda").to(dt)
    pw = prune_kernel.prune_nm_cuda(a)[0]
    w2 = pw.reshape(-1, k)
    v0, v1, codes = prune_kernel.compress_24_cuda(w2)
    # the harness's ELL geometry for this shape: block_k 64 (k < 1536),
    # fold_first (m is not a multiple of 128, m*b is)
    e, kp = build_ell_operand(a, block_size=128, block_k=64,
                              fold_first=m % 128 != 0)
    vals = e.values.reshape(-1, e.values.shape[-1])
    cols = e.col_indices.reshape(-1, e.col_indices.shape[-1])
    bp = torch.nn.functional.pad(b, (0, 0, 0, kp - k))
    a_ell = ell_to_dense(e).reshape(-1, kp)
    kw24 = dict(k_logical=k, out_dtype=dt)
    kwe = dict(block_size=128, block_k=64, out_dtype=dt)
    flops = 2.0 * rows * n * k
    specs = {
        "prune_nm": (prune_kernel.prune_nm_cuda,
                     prune_kernel.prune_nm_plain, (a,), None,
                     rl.prune_sol_ms(m, k, BATCH), "bytes"),
        "compress_24": (prune_kernel.compress_24_cuda,
                        prune_kernel.compress_24_plain, (w2,), None,
                        rl.compress_sol_ms(m, k, BATCH), "bytes"),
        "spmm_24": (lambda *x: spmm24_kernel.spmm24_cuda(*x, **kw24),
                    lambda *x: spmm24_kernel.spmm24_plain(*x, **kw24),
                    (v0, v1, codes, b), (torch.matmul, (w2, b)),
                    rl.spmm24_sol_ms(m, n, k, BATCH),
                    rl.bound_by(flops, rl.H100.sparse24_tflops,
                                1.25 * rows * k + 2 * k * n + 2 * rows * n)),
        "spmm_ell": (lambda *x: ell_kernel.ell_spmm_cuda(*x, **kwe),
                     lambda *x: ell_kernel.ell_spmm_plain(*x, **kwe),
                     (vals, cols, bp), (torch.matmul, (a_ell, bp)),
                     rl.ell_sol_ms(m, n, kp, BATCH),
                     rl.bound_by(flops / 2 * kp / k, rl.H100.dense_tflops,
                                 rows * kp + 2 * kp * n + 2 * rows * n)),
    }
    out = []
    for name, (kern, plain, ops, lib, bound, by) in specs.items():
        ms = time_kernel(kern, ops, iters=20, reps=5).ms
        plain_ms = time_kernel(plain, ops, iters=3, reps=3).ms
        lib_ms = (time_kernel(lib[0], lib[1], iters=20, reps=5).ms
                  if lib else None)
        out.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "shape": f"{m}x{n}x{k}x{BATCH} bf16",
            "launches": counts[name],
            "max_abs_err": checks.named_abs[name],
            "max_err": checks.named_rel[name],
            "ms": ms, "kernel_ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": by, "library_ms": lib_ms,
        })
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
    checks = Checks()
    print("kernels against their plain versions:", flush=True)
    phase_kernels(checks)
    phase_pipeline()
    counts = phase_main_path()
    print(json.dumps(phase_kernel_line(checks, counts)), flush=True)
    print(line, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
