"""The Hopper tile of K4 and K5 (``csrc/ell_tile.cuh``) under every plan.

* ``--plans`` times K4 (and K5 where the sweep runs it, k < 512) on the
  device (``torch.profiler``) at the six bench shapes (b=32, bf16, 50% block
  sparsity, the harness's block sizes) under each plan
  :func:`~sparsifyme_tpu_torch.ops.kernels.ell_kernel.ell_plan` can choose
  (tile width, split count, blocks per SM), forced in place of the picked
  one, each product held to the plain version.
* ``--shapes`` times K4 and K5 at those shapes through their wrappers alone,
  beside ``torch.matmul`` on the dense A and the ELL bound: it runs against
  any tree of the port that has those wrappers, so that one chip call can
  time two trees in turns (``PYTHONPATH=<tree> python <this file>
  --shapes``).
* ``--host`` times the host's part of one K4 call and its pieces.

A measurement script: the port does not import it.

Usage: PYTHONPATH=. python sparsifyme_tpu_torch/bench/ell_probe.py
       [--plans | --shapes | --host]        (needs one GPU)
"""

from __future__ import annotations

import itertools
import subprocess
import sys
import time

import torch

from sparsifyme_tpu_torch.ops.kernels import ell_kernel as ek
from sparsifyme_tpu_torch.utils.timing import time_kernel

SHAPES = [(12544, 64, 147), (12544, 64, 576), (12544, 256, 64),
          (3136, 128, 1152), (784, 256, 1024), (196, 512, 4608)]
BATCH = 32


def _plan(m, n, ell, bk, bn, splits, ctas=1):
    """``ell_plan`` restricted to one tile width, split count and number of
    blocks per SM."""
    return ek.ell_plan(m, n, ell, bk, 128, widths=(bn,),
                       split_counts=(splits,), cta_counts=(ctas,))


def _rel(out, ref):
    out, ref = out.float(), ref.float()
    return float((out - ref).abs().max() / ref.abs().max())


def _ms(fn, ops):
    return time_kernel(fn, ops, iters=20, reps=3).ms


def _operands(m, n, k, gen):
    """The harness's ELL operand of a [32, m, k] bf16 batch at 50% block
    sparsity: (values, cols, padded B, block_k, dense A)."""
    from sparsifyme_tpu_torch.bench.harness import build_ell_operand
    from sparsifyme_tpu_torch.ops.ell import ell_to_dense

    a = torch.randn((BATCH, m, k), generator=gen, device="cuda").to(
        torch.bfloat16)
    b = torch.randn((k, n), generator=gen, device="cuda").to(torch.bfloat16)
    bk = 32 if k < 512 else (64 if k < 1536 else 128)
    ff = m % 128 != 0 and (m * BATCH) % 128 == 0
    e, kp = build_ell_operand(a, block_size=128, block_k=bk, fold_first=ff)
    bp = torch.nn.functional.pad(b, (0, 0, 0, kp - k))
    vals = e.values.reshape(-1, e.values.shape[-1])
    cols = e.col_indices.reshape(-1, e.col_indices.shape[-1])
    return vals, cols, bp, bk, ell_to_dense(e).reshape(-1, kp)


def _kernels(m, n, k, vals):
    fns = [("K4", ek.ell_spmm_cuda, vals)]
    if k < 512:
        fns.append(("K5", ek.ell_expand_spmm_cuda, vals.T.contiguous()))
    return fns


def _want(name, v, cols, bp, kw):
    plain = ek.ell_spmm_plain if name == "K4" else ek.ell_expand_spmm_plain
    return plain(v, cols, bp, **kw)


def plans() -> int:
    gen = torch.Generator(device="cuda").manual_seed(0)
    saved = ek.card_plan
    try:
        for m, n, k in SHAPES:
            vals, cols, bp, bk, _ = _operands(m, n, k, gen)
            rows, ell = vals.shape[0], vals.shape[1] // bk
            for name, fn, v in _kernels(m, n, k, vals):
                for tout in (False, True):
                    kw = dict(block_size=128, block_k=bk,
                              out_dtype=torch.bfloat16, transpose_out=tout)
                    want = _want(name, v, cols, bp, kw)
                    pick = ek.card_plan(vals.get_device(), rows, n, ell, bk,
                                        128)
                    line = (f"{name} {m}x{n}x{k}x{BATCH} tout={int(tout)} "
                            f"picked {pick.bn}/{pick.splits}/{pick.ctas}:")
                    for bn, splits, ctas in itertools.product(
                            ek.TILE_NS, (1, 2, 3, 4), (1, 2)):
                        plan = _plan(rows, n, ell, bk, bn, splits, ctas)
                        if plan is None:
                            continue
                        ek.card_plan = lambda *a, p=plan, **kw_: p
                        err = _rel(fn(v, cols, bp, **kw), want)
                        ms = _device_ms(lambda *x: fn(*x, **kw),
                                        (v, cols, bp))
                        ek.card_plan = saved
                        line += f" {bn}/{splits}/{ctas} {ms:.4f}"
                        if not err < 2e-2:
                            line += f" (BAD rel err {err:.1e})"
                    print(line, flush=True)
            del vals, cols, bp
            torch.cuda.empty_cache()
    finally:
        ek.card_plan = saved
    return 0


def _device_ms(fn, ops, calls=20):
    """Device time per call of ``fn``: every kernel it launches, summed by
    ``torch.profiler``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn(*ops)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn(*ops)
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA)
    return us / 1e3 / calls


def _enqueue_ms(fn, ops, calls=50):
    """The host's time to queue one call, without waiting for the card."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn(*ops)
    ms = (time.perf_counter() - t0) * 1e3 / calls
    torch.cuda.synchronize()
    return ms


def shapes() -> int:
    from sparsifyme_tpu_torch.bench.roofline import ell_sol_ms

    gen = torch.Generator(device="cuda").manual_seed(0)
    for m, n, k in SHAPES:
        vals, cols, bp, bk, dense = _operands(m, n, k, gen)
        lib = _ms(torch.matmul, (dense, bp))
        for name, fn, v in _kernels(m, n, k, vals):
            for tout in (False, True):
                kw = dict(block_size=128, block_k=bk,
                          out_dtype=torch.bfloat16, transpose_out=tout)
                err = _rel(fn(v, cols, bp, **kw), _want(name, v, cols, bp,
                                                        kw))
                call = lambda *x: fn(*x, **kw)  # noqa: E731
                ops = (v, cols, bp)
                print(f"{name} {m}x{n}x{k}x{BATCH} bk={bk} tout={int(tout)} "
                      f"ms={_ms(call, ops):.4f} "
                      f"device_ms={_device_ms(call, ops):.4f} "
                      f"enqueue_ms={_enqueue_ms(call, ops):.4f} "
                      f"matmul_ms={lib:.4f} "
                      f"bound_ms={ell_sol_ms(m, n, k, BATCH):.4f} "
                      f"rel_err={err:.1e}", flush=True)
        del vals, cols, bp, dense
        torch.cuda.empty_cache()
    return 0


def _host_us(fn, calls=200):
    """Microseconds of host time per call of ``fn`` (the card may lag)."""
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) * 1e6 / calls
    torch.cuda.synchronize()
    return us


def host() -> int:
    """The host's time to queue one K4 call at 784x256x1024 (b=32), and its
    parts: the launch through ``_build.Entry`` (the lookup, the stream,
    the C call and the status check), the lookup of the loaded entry, the
    stream pointer, the ctypes launch alone (two tensor-map encodes and
    the kernel launch), ``torch.empty`` of C, and one
    ``cuTensorMapEncodeTiled`` through ctypes beside a trivial driver call
    (ctypes' own cost)."""
    import ctypes

    from sparsifyme_tpu_torch import _build
    from sparsifyme_tpu_torch.ops.kernels.prune_kernel import DTYPE_CODES

    gen = torch.Generator(device="cuda").manual_seed(0)
    vals, cols, bp, bk, _ = _operands(784, 256, 1024, gen)
    (m, ellk), (kb, n) = vals.shape, bp.shape
    kw = dict(block_size=128, block_k=bk, out_dtype=torch.bfloat16)
    ek.ell_spmm_cuda(vals, cols, bp, **kw)  # builds and loads the library
    entry, index = ek.ELL_SPMM, vals.get_device()
    launch = _build._entries[entry.key]
    plan = ek.card_plan(index, m, n, ellk // bk, bk, 128)
    out = torch.empty((m, n), dtype=torch.bfloat16, device="cuda")
    code = DTYPE_CODES[torch.bfloat16]
    args = (vals.data_ptr(), cols.data_ptr(), bp.data_ptr(), None,
            out.data_ptr(), None, m, n, kb, 128, bk, ellk // bk, 1.0, 0.0, 0,
            code, code, *ek.plan_args(plan))
    stream = _build.raw_stream(index)
    driver = ctypes.CDLL("libcuda.so.1")
    tmap = (ctypes.c_uint8 * 128)()
    u64, u32 = ctypes.c_uint64, ctypes.c_uint32
    enc_args = (ctypes.byref(tmap), 9, 2, ctypes.c_void_p(vals.data_ptr()),
                (u64 * 2)(ellk, m), (u64 * 1)(ellk * 2), (u32 * 2)(64, 128),
                (u32 * 2)(1, 1), 0, 3, 3, 0)  # bf16, 128-byte swizzle
    version = ctypes.c_int()
    cases = [
        ("wrapper", lambda: ek.ell_spmm_cuda(vals, cols, bp, **kw)),
        ("entry launch", lambda: entry(index, *args)),
        ("lookup", lambda: _build._entries.get(entry.key)),
        ("stream", lambda: _build.raw_stream(index)),
        ("ctypes launch", lambda: launch(*args, index, stream)),
        ("empty", lambda: torch.empty((m, n), dtype=torch.bfloat16,
                                      device="cuda")),
        ("tensor-map encode", lambda: driver.cuTensorMapEncodeTiled(
            *enc_args)),
        ("driver call", lambda: driver.cuDriverGetVersion(
            ctypes.byref(version))),
    ]
    for name, fn in cases:
        print(f"host {name}: {_host_us(fn):.1f} us", flush=True)
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("ell_probe: needs a CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True,
                          capture_output=True, text=True).stdout.strip()
    print(f"card: {card}", flush=True)
    args = sys.argv[1:]
    if "--host" in args:
        return host()
    return plans() if "--plans" in args else shapes()


if __name__ == "__main__":
    sys.exit(main())
