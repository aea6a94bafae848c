"""Analytic im2col GEMM shapes for the MobileNet / DenseNet families.

The port's own copy of ``sparsifyme_tpu.models.conv_zoo`` (pure shape
data; importing that module would import JAX through its package).

Completes the reference datagen's model zoo (`datasets/get_shapes.py:87-98`
lists resnet18/34/50/101/152, mobilenetv2, mobilenetv3_small/large,
densenet161, densenet201) without a torchvision dependency: every Conv2d
of each architecture is enumerated from its published block tables and
emitted as an `(m, n, k, b)` im2col GEMM shape with m = output H*W,
n = out_channels, k = (in_ch / groups) * kh * kw, b = batch — the same
row schema the reference writes (`get_shapes.py:68-74`).

Notes on fidelity:
* The reference walker includes *every* `nn.Conv2d` (its mobilenet path,
  `get_shapes.py:47-49`, has no downsample filter), so we include
  depthwise convs (k = kh*kw) and MobileNetV3 squeeze-excitation 1x1
  convs (m = 1, they operate on pooled features).
* The reference's mobilenet walker feeds a 244x244 input (a typo-quirk,
  `get_shapes.py:45`); we default to the standard 224 and expose
  `image_size` for bit-parity with the quirk if wanted.
* DenseNet spatial flow uses the true stem max-pool (the reference's
  resnet quirk of ignoring it is specific to its resnet walker and is
  handled in `resnet_shapes.py`).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from ..utils.shapes import LayerShape


def _conv(hw: int, out_ch: int, in_ch: int, ksize: int, batch: int,
          groups: int = 1) -> LayerShape:
    return LayerShape(
        m=hw * hw, n=out_ch, k=(in_ch // groups) * ksize * ksize, b=batch
    )


def _make_divisible(v: float, divisor: int = 8) -> int:
    """torchvision's channel-rounding rule (mobilenet `_make_divisible`)."""
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


# MobileNetV2 inverted-residual table: (expand_ratio, out_ch, repeats, stride)
_V2_BLOCKS: Tuple[Tuple[int, int, int, int], ...] = (
    (1, 16, 1, 1),
    (6, 24, 2, 2),
    (6, 32, 3, 2),
    (6, 64, 4, 2),
    (6, 96, 3, 1),
    (6, 160, 3, 2),
    (6, 320, 1, 1),
)


def mobilenet_v2_conv_shapes(
    image_size: int = 224, batch: int = 32
) -> List[LayerShape]:
    shapes: List[LayerShape] = []
    hw = image_size // 2
    shapes.append(_conv(hw, 32, 3, 3, batch))  # stem 3x3 s2
    in_ch = 32
    for t, c, n, s in _V2_BLOCKS:
        for i in range(n):
            stride = s if i == 0 else 1
            exp = in_ch * t
            if t != 1:
                shapes.append(_conv(hw, exp, in_ch, 1, batch))
            hw //= stride
            shapes.append(_conv(hw, exp, exp, 3, batch, groups=exp))
            shapes.append(_conv(hw, c, exp, 1, batch))
            in_ch = c
    shapes.append(_conv(hw, 1280, in_ch, 1, batch))  # head 1x1
    return shapes


# MobileNetV3 bneck tables: (kernel, expanded_ch, out_ch, use_se, stride)
_V3_LARGE: Tuple[Tuple[int, int, int, bool, int], ...] = (
    (3, 16, 16, False, 1),
    (3, 64, 24, False, 2),
    (3, 72, 24, False, 1),
    (5, 72, 40, True, 2),
    (5, 120, 40, True, 1),
    (5, 120, 40, True, 1),
    (3, 240, 80, False, 2),
    (3, 200, 80, False, 1),
    (3, 184, 80, False, 1),
    (3, 184, 80, False, 1),
    (3, 480, 112, True, 1),
    (3, 672, 112, True, 1),
    (5, 672, 160, True, 2),
    (5, 960, 160, True, 1),
    (5, 960, 160, True, 1),
)
_V3_SMALL: Tuple[Tuple[int, int, int, bool, int], ...] = (
    (3, 16, 16, True, 2),
    (3, 72, 24, False, 2),
    (3, 88, 24, False, 1),
    (5, 96, 40, True, 2),
    (5, 240, 40, True, 1),
    (5, 240, 40, True, 1),
    (5, 120, 48, True, 1),
    (5, 144, 48, True, 1),
    (5, 288, 96, True, 2),
    (5, 576, 96, True, 1),
    (5, 576, 96, True, 1),
)


def mobilenet_v3_conv_shapes(
    variant: str = "large", image_size: int = 224, batch: int = 32
) -> List[LayerShape]:
    table = {"large": _V3_LARGE, "small": _V3_SMALL}[variant]
    shapes: List[LayerShape] = []
    hw = image_size // 2
    shapes.append(_conv(hw, 16, 3, 3, batch))  # stem 3x3 s2
    in_ch = 16
    for ksize, exp, out, use_se, stride in table:
        if exp != in_ch:
            shapes.append(_conv(hw, exp, in_ch, 1, batch))
        hw //= stride
        shapes.append(_conv(hw, exp, exp, ksize, batch, groups=exp))
        if use_se:
            sq = _make_divisible(exp // 4)
            # SE fc1/fc2 are nn.Conv2d on globally-pooled features.
            shapes.append(LayerShape(m=1, n=sq, k=exp, b=batch))
            shapes.append(LayerShape(m=1, n=exp, k=sq, b=batch))
        shapes.append(_conv(hw, out, exp, 1, batch))
        in_ch = out
    shapes.append(_conv(hw, 6 * in_ch, in_ch, 1, batch))  # last 1x1
    return shapes


# DenseNet: (init_features, growth_rate, bn_size, block_layers)
_DENSENET: Dict[str, Tuple[int, int, int, Tuple[int, ...]]] = {
    "densenet161": (96, 48, 4, (6, 12, 36, 24)),
    "densenet201": (64, 32, 4, (6, 12, 48, 32)),
}


def densenet_conv_shapes(
    name: str, image_size: int = 224, batch: int = 32
) -> List[LayerShape]:
    init, growth, bn_size, blocks = _DENSENET[name]
    shapes: List[LayerShape] = []
    hw = image_size // 2
    shapes.append(_conv(hw, init, 3, 7, batch))  # stem 7x7 s2
    hw //= 2  # stem max-pool s2
    ch = init
    for bi, n_layers in enumerate(blocks):
        for _ in range(n_layers):
            shapes.append(_conv(hw, bn_size * growth, ch, 1, batch))
            shapes.append(_conv(hw, growth, bn_size * growth, 3, batch))
            ch += growth
        if bi != len(blocks) - 1:
            ch //= 2
            shapes.append(_conv(hw, ch, ch * 2, 1, batch))  # transition 1x1
            hw //= 2  # transition avg-pool s2
    return shapes


def zoo_conv_shapes(batch: int = 32) -> Dict[str, List[LayerShape]]:
    """The reference zoo's non-resnet members (`get_shapes.py:87-98`)."""
    return {
        "mobilenetv2": mobilenet_v2_conv_shapes(batch=batch),
        "mobilenetv3_small": mobilenet_v3_conv_shapes("small", batch=batch),
        "mobilenetv3_large": mobilenet_v3_conv_shapes("large", batch=batch),
        "densenet161": densenet_conv_shapes("densenet161", batch=batch),
        "densenet201": densenet_conv_shapes("densenet201", batch=batch),
    }
