"""Analytic im2col GEMM shapes for the ResNet family.

The port's own copy of ``sparsifyme_tpu.models.resnet_shapes`` (importing
that module would import JAX through the package ``__init__``). It
replaces the reference's dataset generator
(`datasets/get_shapes.py:22-42,68-74,87-98`), which unfolds every
non-downsample Conv2d of torchvision ResNets into an im2col GEMM shape
`(m, n, k, b)` with m = output H*W, n = out_channels, k = in_ch*kh*kw,
b = 32. The shapes are computed analytically from the published ResNet
architecture instead of tracing torchvision modules; the MobileNet and
DenseNet members of the zoo come from :mod:`.conv_zoo`.
:func:`main` writes every model's CSV, as the JAX module's does::

    python -m sparsifyme_tpu_torch.models.resnet_shapes <outdir> [--batch 32]

Quirk replicated deliberately: the reference's spatial bookkeeping ignores
the stem max-pool (its committed CSVs show layer1 convs at 112x112, e.g.
`datasets/shapes.csv` rows with m=12544 for 64->64 1x1 convs), so the
per-stage spatial sizes are 112/56/28/14 rather than 56/28/14/7. We expose
both behaviors via `include_maxpool`, defaulting to the reference's
(maxpool ignored) so benchmark shapes match `examples/compare.csv`.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from ..utils.shapes import LayerShape

# (block_type, layers_per_stage)
_ARCH: Dict[str, Tuple[str, Tuple[int, int, int, int]]] = {
    "resnet18": ("basic", (2, 2, 2, 2)),
    "resnet34": ("basic", (3, 4, 6, 3)),
    "resnet50": ("bottleneck", (3, 4, 6, 3)),
    "resnet101": ("bottleneck", (3, 4, 23, 3)),
    "resnet152": ("bottleneck", (3, 8, 36, 3)),
}

_STAGE_WIDTH = (64, 128, 256, 512)
_EXPANSION = {"basic": 1, "bottleneck": 4}


def _conv(out_hw: int, out_ch: int, in_ch: int, kh: int, kw: int,
          batch: int) -> LayerShape:
    return LayerShape(m=out_hw * out_hw, n=out_ch, k=in_ch * kh * kw, b=batch)


def resnet_conv_shapes(
    name: str,
    image_size: int = 224,
    batch: int = 32,
    include_maxpool: bool = False,
) -> List[LayerShape]:
    """All non-downsample conv shapes of a ResNet, in forward order.

    Downsample (1x1 shortcut projection) convs are excluded, matching the
    reference generator (`datasets/get_shapes.py` skips them; its row counts
    are 17/33/49/100/151 for resnet18/34/50/101/152).
    """
    if name not in _ARCH:
        raise ValueError(f"unknown model {name!r}; have {sorted(_ARCH)}")
    block, stages = _ARCH[name]
    exp = _EXPANSION[block]
    shapes: List[LayerShape] = []

    # Stem: 7x7 s2 conv, 3 -> 64.
    hw = image_size // 2
    shapes.append(_conv(hw, 64, 3, 7, 7, batch))
    if include_maxpool:
        hw //= 2  # true torchvision spatial flow; reference ignores this

    in_ch = 64
    for stage_idx, (width, n_blocks) in enumerate(zip(_STAGE_WIDTH, stages)):
        stride = 1 if stage_idx == 0 else 2
        for b_idx in range(n_blocks):
            s = stride if b_idx == 0 else 1
            if block == "basic":
                # conv1: 3x3 stride s (spatial halves when s==2)
                out_hw = hw // s
                shapes.append(_conv(out_hw, width, in_ch, 3, 3, batch))
                hw = out_hw
                # conv2: 3x3 s1
                shapes.append(_conv(hw, width, width, 3, 3, batch))
                in_ch = width * exp
            else:
                # conv1: 1x1 s1 (torchvision puts the stride on the 3x3)
                shapes.append(_conv(hw, width, in_ch, 1, 1, batch))
                # conv2: 3x3 stride s
                out_hw = hw // s
                shapes.append(_conv(out_hw, width, width, 3, 3, batch))
                hw = out_hw
                # conv3: 1x1 expansion
                shapes.append(_conv(hw, width * exp, width, 1, 1, batch))
                in_ch = width * exp
    return shapes


def all_model_shapes(batch: int = 32) -> Dict[str, List[LayerShape]]:
    """Every model in the reference datagen zoo (`get_shapes.py:87-98`):
    the ResNet family here, MobileNet/DenseNet from :mod:`.conv_zoo`."""
    from .conv_zoo import zoo_conv_shapes

    out = {name: resnet_conv_shapes(name, batch=batch) for name in _ARCH}
    out.update(zoo_conv_shapes(batch=batch))
    return out


def benchmark_shapes(batch: int = 32) -> List[LayerShape]:
    """The published benchmark sweep: ResNet-50's 49 conv shapes.

    The reference's `datasets/shapes.csv` is byte-identical to
    `datasets/resnet50.csv` (SURVEY.md C16) — the committed `compare.csv`
    benchmark is the ResNet-50 sweep.
    """
    return resnet_conv_shapes("resnet50", batch=batch)


def main(argv: Optional[List[str]] = None) -> None:
    """CLI: write the m,n,k,b CSVs for every model, and the benchmark's
    ``shapes.csv``, into a directory."""
    import argparse
    import os

    from ..utils.shapes import write_shapes

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("outdir", help="directory to write <model>.csv files into")
    p.add_argument("--batch", type=int, default=32)
    args = p.parse_args(argv)
    os.makedirs(args.outdir, exist_ok=True)
    for name, shapes in all_model_shapes(batch=args.batch).items():
        write_shapes(os.path.join(args.outdir, f"{name}.csv"), shapes)
    write_shapes(
        os.path.join(args.outdir, "shapes.csv"), benchmark_shapes(args.batch)
    )


if __name__ == "__main__":
    main()
