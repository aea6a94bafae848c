"""What bounds kernel K6: its time with other depths of B loads in flight.

K6 (``csrc/coo_spmm.cu``) issues ``kGroup`` gathered B loads per thread
before it sums them. This script rebuilds K6 with ``kGroup`` 8, 16, 32
and 64 (one ``nvcc`` each, into a temporary directory), runs each build
through :func:`~..ops.kernels.coo_kernel.spmm_coo_cuda` at BASELINE config
2 shapes (b=32, bf16 B) and prints its time and relative error against
the plain version. If the time does not follow the depth, load latency
does not bound K6. A measurement script: the port does not import it.

Usage: python -m sparsifyme_tpu_torch.bench.coo_probe   (needs one GPU)
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from .. import _build
from ..ops.coo import coo_from_dense, pack_coo
from ..ops.kernels import coo_kernel
from ..ops.prune import prune_threshold
from ..utils.timing import time_kernel

DEPTHS = (8, 16, 32, 64)
SHAPES = [(3136, 128, 1152, 0.9), (196, 512, 4608, 0.5),
          (12544, 64, 576, 0.5), (3136, 128, 1152, 0.99)]  # m, n, k, sp
CONSTANT = "constexpr int kGroup = 16;"


def build(depth: int, out_dir: Path, nvcc: str):
    src = (_build.CSRC / "coo_spmm.cu").read_text()
    if CONSTANT not in src:
        raise RuntimeError(f"coo_spmm.cu no longer holds {CONSTANT!r}")
    cu = out_dir / f"coo_spmm_g{depth}.cu"
    cu.write_text(src.replace(CONSTANT, f"constexpr int kGroup = {depth};"))
    lib = out_dir / f"libcoo_spmm_g{depth}.so"
    subprocess.run([nvcc, *_build.NVCC_FLAGS, "-o", str(lib), str(cu)],
                   check=True, capture_output=True)
    fn = ctypes.CDLL(str(lib)).coo_spmm_launch
    fn.argtypes = _build.argtypes("ppppp" "iiiiiii" "ii" "p")
    fn.restype = ctypes.c_int
    return fn


def main() -> int:
    if not torch.cuda.is_available():
        print("coo_probe: needs a CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True,
                          capture_output=True, text=True).stdout.strip()
    print(f"card: {card}", flush=True)
    nvcc = _build.find_nvcc()
    with tempfile.TemporaryDirectory() as tmp:
        with ThreadPoolExecutor(len(DEPTHS)) as pool:
            fns = dict(zip(DEPTHS, pool.map(
                lambda d: build(d, Path(tmp), nvcc), DEPTHS)))
        gen = torch.Generator(device="cuda").manual_seed(0)
        for m, n, k, sp in SHAPES:
            a = torch.randn((m, k), generator=gen, device="cuda")
            thr = float(torch.quantile(a.abs().flatten(), sp))
            packed = pack_coo(coo_from_dense(prune_threshold(a, thr)[0]))
            b = torch.randn((32, k, n), generator=gen,
                            device="cuda").to(torch.bfloat16)
            want = coo_kernel.spmm_coo_plain(*packed, b, m=m)
            line = f"{m}x{n}x{k}x32 sp={sp}:"
            for depth, fn in fns.items():
                _build._entries["coo_spmm"] = fn  # the wrapper's loader
                got = coo_kernel.spmm_coo_cuda(*packed, b, m=m)
                err = float((got - want).abs().max() / want.abs().max())
                ms = time_kernel(
                    lambda *x: coo_kernel.spmm_coo_cuda(*x, m=m),
                    (*packed, b), iters=10, reps=3).ms
                line += f" kGroup={depth}: {ms:.4f} ms (rel err {err:.1e});"
            print(line, flush=True)
    _build._entries.pop("coo_spmm", None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
