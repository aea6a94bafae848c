"""Where a sparse conv layer's time goes: the patch gather, the SpMM, the
whole layer, against cuDNN.

At the model path's three ResNet-50 convs (``chip_smoke.py``: conv1 7x7/2,
layer2.0.conv2 3x3/2, a layer3 conv2 3x3/1; b=32, bf16) each layer
(:class:`~..models.sparse_conv.SparseConv2d`, and
:class:`~..models.sparse_conv.EllConv2d` where out_ch fills a 128-row
block) is timed whole, its SpMM alone on a prepared B (K3 or K4), its
patch gather alone (``patch`` — one copy from a padded NCHW copy of the
input, the layer's route) beside ``F.unfold`` followed by the copy to
``[k, rows]`` (``unfold``, the reference it is checked equal to), and
``F.conv2d`` on the dense pruned weight, channels-last (``cudnn``). Each
row is timed in turns with the others in one process.

A measurement script: the port does not import it.

Usage: python -m sparsifyme_tpu_torch.bench.conv_probe   (needs one GPU)
"""

from __future__ import annotations

import json
import subprocess
import sys

import torch
import torch.nn.functional as F

from ..models.sparse_conv import (EllConv2d, SparseConv2d, _pads,
                                  _patch_columns)
from ..ops.ell import spmm_ell
from ..ops.sparse24 import spmm_24
from ..utils.timing import time_kernel

# name, in_ch, out_ch, kernel, stride, input H = W: ResNet-50's stem, its
# first stride-2 3x3 (XLA pads it (0, 1)) and a layer3 3x3; chip_smoke.py's
# model phase runs the same layers
CONVS = [("resnet50 conv1", 3, 64, 7, 2, 224),
         ("resnet50 layer2.0.conv2", 128, 128, 3, 2, 56),
         ("resnet50 layer3.1.conv2", 256, 256, 3, 1, 14)]
BATCH = 32


def unfold_columns(x, kh, kw, stride, padding):
    """``patches^T`` through ``F.unfold`` on the padded NCHW view, then a
    copy to ``[k, rows]``."""
    xp = F.pad(x.permute(0, 3, 1, 2),
               _pads(*x.shape[1:3], kh, kw, stride, padding))
    cols = F.unfold(xp, (kh, kw), stride=stride)  # [b, k, L]
    return cols.permute(1, 0, 2).reshape(cols.shape[1], -1)


def cudnn_conv(layer):
    """``F.conv2d`` (cuDNN) on the layer's dense pruned weight,
    channels-last, XLA's padding included."""
    w = layer.dense_weight().detach().contiguous(
        memory_format=torch.channels_last)

    def run(x):
        xp = F.pad(x.permute(0, 3, 1, 2),
                   _pads(*x.shape[1:3], layer.kh, layer.kw, layer.stride,
                         layer.padding))
        xp = xp.contiguous(memory_format=torch.channels_last)
        return F.conv2d(xp, w, stride=layer.stride).permute(0, 2, 3, 1)
    return run


def _ms(fn, ops):
    return time_kernel(fn, ops, iters=10, reps=3).ms


def main() -> int:
    if not torch.cuda.is_available():
        print("conv_probe: needs a CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True,
                          capture_output=True, text=True).stdout.strip()
    print(f"card: {card}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    with torch.no_grad():
        for name, cin, cout, ksz, stride, hw in CONVS:
            w = torch.randn((cout, cin, ksz, ksz), generator=gen,
                            device="cuda").to(torch.bfloat16)
            x = torch.randn((BATCH, hw, hw, cin), generator=gen,
                            device="cuda").to(torch.bfloat16)
            layers = [SparseConv2d(w, stride=stride)]
            if cout % 128 == 0:
                layers.append(EllConv2d(w, stride=stride))
            geo = (ksz, ksz, stride, "SAME")
            bt = _patch_columns(x, *geo)[0]
            if not torch.equal(bt, unfold_columns(x, *geo)):
                raise AssertionError(f"{name}: the gather differs from F.unfold")
            for layer in layers:
                if isinstance(layer, SparseConv2d):
                    spmm = (lambda b, lay=layer: spmm_24(
                        lay.weight, b, transpose_out=True))
                    b_op = bt
                else:
                    b_op = F.pad(bt, (0, 0, 0, layer.k_padded - bt.shape[0]))
                    spmm = (lambda b, lay=layer: spmm_ell(
                        lay.weight, b, transpose_out=True))
                row = {"layer": name, "class": type(layer).__name__,
                       "patches": [bt.shape[1], bt.shape[0]]}
                for _ in range(2):  # in turns, twice
                    for key, fn, ops in (
                            ("layer_ms", layer, (x,)),
                            ("spmm_ms", spmm, (b_op,)),
                            ("patch_ms", lambda t: _patch_columns(t, *geo),
                             (x,)),
                            ("unfold_ms", lambda t: unfold_columns(t, *geo),
                             (x,)),
                            ("cudnn_ms", cudnn_conv(layer), (x,))):
                        row.setdefault(key, []).append(_ms(fn, ops))
                print(json.dumps(row), flush=True)
            del layers, bt, x, w
            torch.cuda.empty_cache()
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
