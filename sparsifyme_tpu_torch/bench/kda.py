"""Kimi Delta Attention's recurrence kernel against its plain versions, at
Kimi Linear's prefill: 8 sequences of 4096 tokens, 32 heads of 128.

:func:`check` holds :func:`~..ops.kernels.kda_kernel.kda_chunk_cuda` to the
plain chunked form (:func:`~..ops.kernels.kda_kernel.kda_chunk_plain`) run
in float64 on the same bf16 inputs, which the CPU tests hold to the token
recurrence: within :data:`TOL` of it, and within :data:`ROUNDED_TOL` of it
rounded to bf16 (:func:`rounded_err`, the error beyond the rounding of a
bf16 output). The second tells the kernel's float32 state from a bf16 one,
which the first cannot: :func:`state_bf16_err` reads the plain form with
its state rounded to bf16 after each chunk, which must exceed it where
the decays are weak and the state carries. :func:`check_glue` holds the
block's three glue kernels to their plain versions at the model's shapes.
:func:`measure` gives the kernel's device ms a call, split
into its two launches (the chunks' transforms, the scan over chunks) by
the profiler, beside its least time (q, k, v, the decay's input and o at 2
B an element and beta at 4 B, at 3.35 TB/s; the work, 98 KFLOP a
head-token, at 989 TFLOP/s, is four times shorter) and the plain chunked
form's in float32 on the card.

A measurement script: the port does not import it.

Usage (needs one GPU and ``nvcc``)::

    python -m sparsifyme_tpu_torch.bench.kda [--iters 5]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from typing import Tuple

import torch
import torch.nn.functional as F

from ..ops.kernels import kda_kernel
from ..utils.timing import time_kernel
from . import roofline

HEADS, D = 32, kda_kernel.HEAD_DIM
BATCH, SEQ = 8, 4096
# the recurrence's tolerances against the float64 plain form: relative,
# and relative beyond the rounding of a bf16 o (a float32 state reads
# ~5e-5 there, a bf16 one 1.6e-3 at weak decays)
TOL, ROUNDED_TOL = 6e-3, 5e-4
FLOPS = 4 * D * D + 2 * kda_kernel.CHUNK * 2 * D  # a head-token, least
BYTES = 5 * D * 2 + 4  # q, k, v, the decay's input, o; beta


def operands(batch: int, seq: int, strong: bool, device, seed: int = 0,
             heads: int = HEADS) -> Tuple[torch.Tensor, ...]:
    """``(q, k, v, g, beta)`` as the model gives them: q and k unit per
    head, v SiLU-like, bf16; the log-decay ``g`` float32, near 0 (weak) or
    up to -3 a token with a chunk's mean near -1.6 (strong), beta in (0,
    1)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    t = batch * seq

    def unit():
        x = torch.randn((heads, D, t), generator=gen, device=device)
        return F.normalize(x, dim=1).reshape(heads * D, t).to(torch.bfloat16)

    q, k = unit(), unit()
    v = F.silu(torch.randn((heads * D, t), generator=gen, device=device))
    u = torch.rand((heads * D, t), generator=gen, device=device)
    g = -(u * 3.2 if strong else u * 0.02)
    beta = torch.rand((heads, t), generator=gen, device=device)
    return q, k, v.to(torch.bfloat16), g, beta


def rel_err(got: torch.Tensor, want: torch.Tensor) -> Tuple[float, float]:
    """``(Frobenius, max)`` error of ``got`` against ``want``, each over
    ``want``'s Frobenius norm and largest magnitude."""
    d = got.double() - want.double()
    return (float(d.norm() / want.double().norm()),
            float(d.abs().max() / want.double().abs().max()))


def rounded_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """The Frobenius norm of bf16 ``got`` less ``want`` rounded to bf16,
    over ``want``'s: zero where every element is the correctly rounded
    one."""
    d = got.double() - want.to(torch.bfloat16).double()
    return float(d.norm() / want.double().norm())


def check(batch: int, seq: int, strong: bool, seed: int = 0
          ) -> Tuple[float, float, float]:
    """One kernel call against the plain chunked form in float64 on the
    same inputs: :func:`rel_err` and :func:`rounded_err`; raises where the
    call does not count one launch, gives a non-finite value, or differs on
    a second call."""
    q, k, v, g, beta = operands(batch, seq, strong, "cuda", seed)
    before = kda_kernel.kda_chunk_cuda.launches
    got = kda_kernel.kda_chunk_cuda(q, k, v, g, beta, batch)
    if kda_kernel.kda_chunk_cuda.launches != before + 1:
        raise AssertionError("kda: the call did not count one launch")
    again = kda_kernel.kda_chunk_cuda(q, k, v, g, beta, batch)
    if not torch.equal(got, again):
        raise AssertionError("kda: two calls differ")
    if not bool(torch.isfinite(got).all()):
        raise AssertionError("kda: a value is not finite")
    want = kda_kernel.kda_chunk_plain(q, k, v, g.double(), beta, batch)
    return (*rel_err(got, want), rounded_err(got, want))


def state_bf16_err(batch: int, seq: int, strong: bool, seed: int = 0
                   ) -> float:
    """:func:`rounded_err` of the plain chunked form with its state
    rounded to bf16 after each chunk (float32 otherwise, bf16 o), a
    precision one step below the kernel's, on :func:`check`'s inputs."""
    q, k, v, g, beta = operands(batch, seq, strong, "cuda", seed)
    got = kda_kernel.kda_chunk_plain(q, k, v, g, beta, batch,
                                     state_dtype=torch.bfloat16)
    want = kda_kernel.kda_chunk_plain(q, k, v, g.double(), beta, batch)
    return rounded_err(got.to(torch.bfloat16), want)


# the glue kernels' tolerances against their plain versions, relative:
# about ten times their readings on an H100 at the model's shapes (conv
# 7.1e-6, decay 8.4e-8, gated norm 1.26e-5: one float32 result, rounded
# once to bf16, differing where the two sum in another order)
GLUE_TOL = {"conv": 1e-4, "decay": 1e-6, "gate_norm": 2e-4}


def check_glue(batch: int = BATCH, seq: int = SEQ, heads: int = HEADS,
               seed: int = 0) -> dict:
    """The conv (q, k and v: ``3 * heads * 128`` rows, q's and k's
    L2-normed), decay and gated norm kernels (``heads * 128`` rows) at
    ``batch`` sequences of ``seq`` tokens against their plain versions on
    the card: each one's :func:`rel_err`; raises where a call does not
    count one launch or gives a non-finite value."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rows, t = heads * D, batch * seq

    def randn(shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    def launch(fn, *args):
        before = fn.launches
        out = fn(*args)
        if fn.launches != before + 1:
            raise AssertionError(f"{fn.__name__}: not one launch")
        if not bool(torch.isfinite(out).all()):
            raise AssertionError(f"{fn.__name__}: a value is not finite")
        return out

    x = randn((3 * rows, t)).to(torch.bfloat16)
    w = (torch.rand((3 * rows, 4), generator=gen, device="cuda") - 0.5).to(
        torch.bfloat16)
    out = {"conv": rel_err(
        launch(kda_kernel.kda_conv_cuda, x, w, batch, 2 * rows, 1e-6),
        kda_kernel.kda_conv_plain(x, w, batch, 2 * rows, 1e-6))}
    del x, w
    f = randn((rows, t), 3.0).to(torch.bfloat16)
    a_log = torch.rand(heads, generator=gen, device="cuda").mul_(
        16 - 1).add_(1).log_()
    dt_bias = randn((rows,), 2.0) - 4
    out["decay"] = rel_err(
        launch(kda_kernel.kda_decay_cuda, f, a_log, dt_bias),
        kda_kernel.kda_decay_plain(f, a_log, dt_bias))
    del f
    o, gate = (randn((rows, t)).to(torch.bfloat16) for _ in range(2))
    wn = (1 + 0.2 * randn((D,))).to(torch.bfloat16)
    out["gate_norm"] = rel_err(
        launch(kda_kernel.kda_gate_norm_cuda, o, gate, wn, 1e-5),
        kda_kernel.kda_gate_norm_plain(o, gate, wn, 1e-5))
    return out


def device_ms(prof) -> dict:
    """Device ms by kernel name of a profiler session's KDA launches."""
    out = {}
    for evt in prof.key_averages():
        for name in ("kda_chunk_prep", "kda_chunk_scan"):
            if name in evt.key:
                out[name] = getattr(evt, "device_time_total",
                                    getattr(evt, "cuda_time_total", 0))
    return out


def measure(iters: int = 5) -> dict:
    """At :data:`BATCH` x :data:`SEQ` tokens and :data:`HEADS` heads, strong
    decays: the check, the kernel's ms a call (host clock after a warm-up,
    and each launch's device time), the least time and the plain chunked
    form's ms in float32."""
    err = check(BATCH, SEQ, True)
    weak = check(BATCH, SEQ, False)
    short = check(BATCH, 128, False)
    q, k, v, g, beta = operands(BATCH, SEQ, True, "cuda")
    ms = time_kernel(kda_kernel.kda_chunk_cuda, (q, k, v, g, beta, BATCH),
                     iters=iters, reps=3).ms
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            kda_kernel.kda_chunk_cuda(q, k, v, g, beta, BATCH)
        torch.cuda.synchronize()
    split = {n: us / iters / 1e3 for n, us in device_ms(prof).items()}
    plain_ms = time_kernel(kda_kernel.kda_chunk_plain,
                           (q, k, v, g, beta, BATCH), iters=1, reps=1).ms
    head_tokens = HEADS * BATCH * SEQ
    least = max(head_tokens * BYTES / (roofline.H100.hbm_gbps * 1e9),
                head_tokens * FLOPS / 989e12) * 1e3
    return {"batch": BATCH, "seq": SEQ, "heads": HEADS,
            "rel_err": err[0], "max_err": err[1], "rounded_err": err[2],
            "weak_rel_err": weak[0], "weak_rounded_err": weak[2],
            "short_rel_err": short[0], "short_rounded_err": short[2],
            "state_bf16_rounded_err": state_bf16_err(BATCH, SEQ, True),
            "weak_state_bf16_rounded_err": state_bf16_err(BATCH, SEQ, False),
            "short_state_bf16_rounded_err": state_bf16_err(BATCH, 128, False),
            "glue_rel_err": check_glue(),
            "ms": ms, "device_ms": split, "least_ms": least,
            "roofline_pct": 100 * least / ms, "plain_ms": plain_ms}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kda: needs a CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True,
                          capture_output=True, text=True).stdout.strip()
    print(f"card: {card}", flush=True)
    print(json.dumps({"kda": measure(args.iters)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
