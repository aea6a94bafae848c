"""Faults planted in Kimi Linear's own mechanisms (KDA's decay, beta, q/k
L2 norm, short convolution, per-sequence state and output gate; NoPE in
the MLA layers; the shared expert), each run through the harness like a
run of the cell (set-up, a short window, the comparison of the last pass),
so that each reads ``correct`` false at the cell's own size. One more,
``state_rounded_to_bf16`` (the recurrence in PyTorch with its state
rounded to bf16 after every chunk, a precision one step down), is read
and reported, not required to fail. The benchmark's own runs never run
this::

    python3 -m perfbench.faults_kimi --workload <cell> --seeds <n> ... [--faults <name> ...]

Prints one JSON line a (fault, seed): ``correct`` and the checks. The
route must drive ``models/kda.py``'s ``kda_attention``, ``models/mla.py``'s
``mla_attention`` and ``models/moe_transformer.py``'s ``moe_shared``
through their modules (as ``model_routes/kimilinear24.py`` does).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

from . import harness
from .run import CACHES, ROOT

FAULTS = ["decay_left_out", "beta_left_out", "qk_norm_left_out",
          "short_conv_left_out", "state_across_sequences", "rope_in_mla",
          "output_gate_left_out", "shared_expert_skipped"]
REPORTED = ["state_rounded_to_bf16"]  # read, not required to fail


def _bf16_state_recurrence(q, k, v, g, beta, batch):
    """The plain chunked form in float32 with its state rounded to bf16
    after each chunk, bf16 o."""
    import torch
    from sparsifyme_tpu_torch.ops.kernels import kda_kernel as kk

    return kk.kda_chunk_plain(q, k, v, g, beta, batch,
                              state_dtype=torch.bfloat16).to(torch.bfloat16)


def _no_conv(x, w, batch, normed, d):
    """SiLU and the q and k L2 norms without the convolution (plain
    PyTorch, float32 inside)."""
    import torch
    from sparsifyme_tpu_torch.models import kda

    y = torch.nn.functional.silu(x.float())
    yh = y[:normed].view(-1, d, y.shape[1])
    yh *= yh.square().sum(1, keepdim=True).add_(kda.L2_EPS).rsqrt_()
    return y.to(torch.bfloat16)


@contextlib.contextmanager
def planted(fault: str):
    """``fault`` planted in the model's modules while the blocks run."""
    import torch
    from sparsifyme_tpu_torch.models import kda, mla
    from sparsifyme_tpu_torch.models import moe_transformer as mt
    saved = [(kda, name, getattr(kda, name))
             for name in ("gates", "short_conv", "recurrence", "gated_norm")]
    saved += [(mla, "uses_rope", mla.uses_rope),
              (mt, "moe_shared", mt.moe_shared)]
    real = dict((name, fn) for _, name, fn in saved)

    def gates(fn):
        def planted_gates(p, low, d):
            return fn(*real["gates"](p, low, d))
        return planted_gates

    def skipped(p, h, d):
        d.normed = None
        return h

    try:
        if fault == "decay_left_out":
            kda.gates = gates(lambda g, b, x: (torch.zeros_like(g), b, x))
        elif fault == "beta_left_out":
            kda.gates = gates(lambda g, b, x: (g, torch.ones_like(b), x))
        elif fault == "qk_norm_left_out":
            kda.short_conv = lambda x, w, batch, normed, d: \
                real["short_conv"](x, w, batch, 0, d)
        elif fault == "short_conv_left_out":
            kda.short_conv = _no_conv
        elif fault == "state_across_sequences":
            kda.recurrence = lambda q, k, v, g, beta, batch: \
                real["recurrence"](q, k, v, g, beta, 1)
        elif fault == "rope_in_mla":
            mla.uses_rope = lambda config: True
        elif fault == "output_gate_left_out":
            kda.gated_norm = lambda o, w, gate, eps: \
                real["gated_norm"](o, w, torch.full_like(gate, 30.0), eps)
        elif fault == "shared_expert_skipped":
            mt.moe_shared = skipped
        elif fault == "state_rounded_to_bf16":
            kda.recurrence = _bf16_state_recurrence
        else:
            raise KeyError(fault)
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--faults", nargs="+", default=FAULTS + REPORTED,
                   choices=FAULTS + REPORTED)
    p.add_argument("--seconds", type=float, default=1.0)
    args = p.parse_args(argv)
    for var, sub in CACHES.items():
        os.environ[var] = str(ROOT / ".perfbench_cache" / sub)
    cell = harness.load_cell(args.workload, ROOT)
    import torch
    if not torch.cuda.is_available() or cell.chips != 1:
        harness.log(f"{cell.name}: one CUDA card and a one-card cell")
        return 2
    kind = torch.cuda.get_device_name(0)
    for fault in args.faults:
        job = {"workload": cell.name, "root": str(ROOT), "seeds": args.seeds,
               "seconds": args.seconds, "trace": False, "t0": time.time(),
               "device": "cuda", "timeout_s": 3000}
        with planted(fault):
            runs = harness.run_job(job)
        for seed, ranks in zip(args.seeds, runs):
            line = harness.result_line(cell, ranks, False, "cuda", kind)
            print(json.dumps({"fault": fault, "seed": seed,
                              "correct": line["correct"],
                              "checks": line["checks"]}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
