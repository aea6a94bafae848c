"""The sparse tensor-core tile of K3 and K7 at every tile size.

The tile is ``csrc/sp24_tile.cuh``. At the six bench shapes and three more
(b=32, bf16), K3 is timed through
:func:`~..ops.kernels.spmm24_kernel.spmm24_cuda` with each tile of
``spmm24_kernel.SP_TILES`` forced in place of
:func:`~..ops.kernels.spmm24_kernel.pick_tile`, beside the tile the rule
picks, and the picked tile's product is checked against the plain version.

A measurement script: the port does not import it.

Usage: python -m sparsifyme_tpu_torch.bench.sp24_probe   (needs one GPU)
"""

from __future__ import annotations

import subprocess
import sys

import torch

from ..ops.kernels import spmm24_kernel as k3
from ..ops.kernels.prune_kernel import prune_nm_cuda
from ..ops.sparse24 import compress_24
from ..utils.timing import time_kernel

# the six bench shapes, then three where the 256-row tile's conditions in
# pick_tile decide (one wave and a bit; a shallow k; eight k-steps)
SHAPES = [(12544, 64, 147), (12544, 64, 576), (12544, 256, 64),
          (3136, 128, 1152), (784, 256, 1024), (196, 512, 4608),
          (196, 2048, 512), (3136, 512, 128), (784, 512, 1024)]


def _ms(fn, ops):
    return time_kernel(fn, ops, iters=20, reps=3).ms


def main() -> int:
    if not torch.cuda.is_available():
        print("sp24_probe: needs a CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True,
                          capture_output=True, text=True).stdout.strip()
    print(f"card: {card}", flush=True)
    pick = k3.card_tile
    gen = torch.Generator(device="cuda").manual_seed(0)
    try:
        for m, n, k in SHAPES:
            a = torch.randn((32 * m, k), generator=gen,
                            device="cuda").to(torch.bfloat16)
            b = torch.randn((k, n), generator=gen,
                            device="cuda").to(torch.bfloat16)
            s = compress_24(prune_nm_cuda(a)[0])
            ops = (s.values0, s.values1, s.codes, b)
            kw = dict(k_logical=k, out_dtype=torch.bfloat16)
            want = k3.spmm24_plain(*ops, **kw).float()
            got = k3.spmm24_cuda(*ops, **kw).float()
            err = float((got - want).abs().max() / want.abs().max())
            tile = k3.SP_TILES[pick(a.device, 32 * m, n, k)]
            ms = _ms(lambda *x: k3.spmm24_cuda(*x, **kw), ops)
            line = (f"{m}x{n}x{k}x32 picked {tile[0]}x{tile[1]}: {ms:.4f} "
                    f"(rel err {err:.1e}) | tiles")
            for t, (bm, bn) in enumerate(k3.SP_TILES):
                k3.card_tile = lambda *x, t=t: t
                ms = _ms(lambda *x: k3.spmm24_cuda(*x, **kw), ops)
                k3.card_tile = pick
                line += f" {bm}x{bn} {ms:.4f}"
            print(line, flush=True)
            del a, b, s, ops, want, got
    finally:
        k3.card_tile = pick
    return 0


if __name__ == "__main__":
    sys.exit(main())
