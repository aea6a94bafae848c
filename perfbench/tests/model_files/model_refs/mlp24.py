"""Plain float32 reference of the 2:4 MLP that route ``mlp24`` drives:
``h = relu(h @ W^T + bias)`` a layer, no ReLU after the last, on weights
already cut 2:4. Imports nothing but ``torch``.

The control (:func:`control_forward`) is this reference one precision
down: every layer's input and weight rounded to fp8 (e4m3), float32
accumulation, the layer's output rounded to bf16, as the configuration
states bf16 in and out.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

Layers = List[Tuple[torch.Tensor, torch.Tensor]]


def _strict_f32() -> None:
    # a float32 product on the card may otherwise run in TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def forward(x: torch.Tensor, layers: Layers) -> torch.Tensor:
    """``x [tokens, d_in]`` through ``(W [d_out, d_in], bias)`` layers."""
    _strict_f32()
    h = x.float()
    for i, (w, bias) in enumerate(layers):
        h = h @ w.float().T + bias.float()
        if i < len(layers) - 1:
            h = torch.relu(h)
    return h


def control_forward(x: torch.Tensor, layers: Layers) -> torch.Tensor:
    """:func:`forward` with fp8 e4m3 inputs and weights, bf16 outputs."""
    _strict_f32()
    f8 = torch.float8_e4m3fn
    h = x
    for i, (w, bias) in enumerate(layers):
        h = h.to(f8).float() @ w.to(f8).float().T + bias.float()
        if i < len(layers) - 1:
            h = torch.relu(h)
        h = h.to(torch.bfloat16)
    return h
