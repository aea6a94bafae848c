"""The RMSNorm kernel against its plain version at the model cells' four
norm shapes.

A prefill of 32768 tokens norms the residual stream (float32) at MiMo-V2-
Flash's hidden 4096 and DeepSeek-V3's 7168, and DeepSeek-V3's two latents
(bf16) at 1536 and 512. :data:`SHAPES` lists each with the layouts its
callers ask for: feature-major for attention, the dense FFN and the final
norm, token-major for MiMo's router (no shared expert), both for
DeepSeek-V3's (the shared expert reads the feature-major one).
:func:`measure` holds :func:`~..ops.kernels.norm_kernel.rms_norm_cuda` to
:func:`~..ops.kernels.norm_kernel.rms_norm_plain` (every element within
one bf16 ulp: the f32 sum is taken in another order) and gives the
kernel's device ms a call beside its least time (h read once, each output
written once in bf16, at 3.35 TB/s) and the plain version's (its four
PyTorch calls, and the transpose for a token-major output, which is also
the library's yardstick: what the model ran before the kernel).

A measurement script: the port does not import it.

Usage (needs one GPU and ``nvcc``)::

    python -m sparsifyme_tpu_torch.bench.rms_norm [--iters 20]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from typing import Optional, Tuple

import torch

from ..ops.kernels import norm_kernel
from ..utils.timing import time_graph, time_kernel
from . import roofline

TOKENS = 32768
EPS = 1e-6
# (hidden, input dtype, feature-major out, token-major out)
SHAPES = [
    (4096, torch.float32, True, False),   # MiMo: attention, FFN, final
    (4096, torch.float32, False, True),   # MiMo: the router
    (7168, torch.float32, True, False),   # DeepSeek-V3: attention, FFN, final
    (7168, torch.float32, True, True),    # DeepSeek-V3: the router
    (1536, torch.bfloat16, True, False),  # DeepSeek-V3: the q latent
    (512, torch.bfloat16, True, False),   # DeepSeek-V3: the kv latent
]


def operands(hidden: int, tokens: int, dtype: torch.dtype, device,
             seed: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(h, w)``: ``h [hidden, tokens]`` of ``dtype`` with columns of
    varied scale (as a residual stream's tokens are) and a bf16 weight
    around 1."""
    g = torch.Generator(device=device).manual_seed(seed)
    h = torch.randn((hidden, tokens), generator=g, device=device)
    h *= torch.rand((1, tokens), generator=g, device=device) * 4 + 0.05
    w = 1 + 0.2 * torch.randn(hidden, generator=g, device=device)
    return h.to(dtype), w.to(torch.bfloat16)


def outputs(h: torch.Tensor, feature: bool, token: bool
            ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    hidden, tokens = h.shape
    return (torch.empty((hidden, tokens), dtype=torch.bfloat16,
                        device=h.device) if feature else None,
            torch.empty((tokens, hidden), dtype=torch.bfloat16,
                        device=h.device) if token else None)


def plain(h: torch.Tensor, w: torch.Tensor, feature: bool, token: bool):
    """The plain version in the layouts asked for (h in float32)."""
    x = norm_kernel.rms_norm_plain(h.float(), w, EPS)
    return (x if feature else None), (x.T.contiguous() if token else None)


def ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    """The most bf16 steps between ``a`` and ``b`` elementwise (bf16, +0
    and -0 one value)."""
    def order(t):
        i = t.view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -(i & 0x7FFF), i)
    return int((order(a) - order(b)).abs().max())


def least_ms(hidden: int, tokens: int, itemsize: int, outs: int) -> float:
    """The norm's least time on the H100: h read once, ``outs`` bf16
    outputs written once and the weight, at 3.35 TB/s."""
    byts = hidden * tokens * (itemsize + 2 * outs) + 2 * hidden
    return byts / (roofline.H100.hbm_gbps * 1e9) * 1e3


def check(hidden: int, tokens: int, dtype: torch.dtype, feature: bool,
          token: bool, seed: int = 0) -> int:
    """One kernel call against the plain version on the card; the most
    bf16 steps between them. Raises where a call does not count one
    launch, moves h, reaches past one bf16 ulp, or differs on a second
    call."""
    h, w = operands(hidden, tokens, dtype, "cuda", seed)
    keep, before = h.clone(), norm_kernel.rms_norm_cuda.launches
    got = outputs(h, feature, token)
    norm_kernel.rms_norm_cuda(h, w, EPS, *got)
    if norm_kernel.rms_norm_cuda.launches != before + 1:
        raise AssertionError("rms_norm: the call did not count one launch")
    again = outputs(h, feature, token)
    norm_kernel.rms_norm_cuda(h, w, EPS, *again)
    want = plain(h, w, feature, token)
    if not torch.equal(h, keep):
        raise AssertionError("rms_norm: the kernel wrote h")
    most = 0
    for g, a, p in zip(got, again, want):
        if p is None:
            continue
        if not torch.equal(g, a):
            raise AssertionError("rms_norm: two calls differ")
        most = max(most, ulps(g, p))
    if most > 1:
        raise AssertionError(f"rms_norm: {most} bf16 ulps from the plain "
                             f"version at {hidden} x {tokens} {dtype}")
    return most


def measure(iters: int = 20) -> list:
    """Each of :data:`SHAPES` at :data:`TOKENS` tokens: the check, the
    kernel's and the plain version's device ms and the least time."""
    recs = []
    for hidden, dtype, feature, token in SHAPES:
        most = check(hidden, TOKENS, dtype, feature, token)
        h, w = operands(hidden, TOKENS, dtype, "cuda")
        outs = outputs(h, feature, token)
        cluster, rows = norm_kernel.norm_plan(hidden, h.element_size(),
                                              token)
        ms = time_graph(norm_kernel.rms_norm_cuda, (h, w, EPS, *outs),
                        iters=iters, reps=5).ms
        plain_ms = time_kernel(plain, (h, w, feature, token), iters=5,
                               reps=3).ms
        least = least_ms(hidden, TOKENS, h.element_size(),
                         int(feature) + int(token))
        rec = {"hidden": hidden, "tokens": TOKENS,
               "dtype": str(dtype).split(".")[1],
               "layouts": "+".join(n for n, on in (("feature", feature),
                                                   ("token", token)) if on),
               "cluster": cluster, "rows": rows, "max_ulps": most, "ms": ms,
               "least_ms": least, "roofline_pct": 100 * least / ms,
               "plain_ms": plain_ms}
        recs.append(rec)
        del h, w, outs
        torch.cuda.empty_cache()
    return recs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("rms_norm: needs a CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True,
                          capture_output=True, text=True).stdout.strip()
    print(f"card: {card}", flush=True)
    for rec in measure(args.iters):
        print(json.dumps({"rms_norm": rec}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
