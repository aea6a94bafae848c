"""Wrapper of the MoE combine kernel (``csrc/moe_combine.cu``) beside its
plain PyTorch version.

The kernel replaces no TPU kernel: the JAX package has no
mixture-of-experts model. It is the last step of
:func:`~..models.moe_transformer.moe_combine`: the residual stream ``h
[hidden, tokens]`` (float32, feature-major) plus, at each token, the rows
of the experts' output ``y [rows, hidden]`` (bf16, token-major) that this
card's experts computed for it, each times its routing weight. Both
versions compute the same function of one dispatch; each reads it the way
it walks:

* the plain version scatters rows: ``index [rows]`` is each row's token
  (the padding rows weigh 0);
* the kernel gathers them: ``slot [tokens, top]`` is each (token, choice)'s
  row, or -1 where another card holds the chosen expert, so it reads each
  held row once and never a padding row.

The sum is bound by device-memory bytes (h read and the output written
once in float32, each held row of y read once in bf16); the source says how
the kernel meets that bound in one pass.
"""

from __future__ import annotations

import torch

from ... import _build
from ...utils import trace

# (h, y, slot, weight, out, tokens, hidden, top, device, stream)
MOE_COMBINE = _build.Entry("moe_combine", "moe_combine_launch",
                           "ppppp" "iii" "i" "p")
MAX_TOP = 16  # choices a token that the kernel takes, at most


def moe_combine_plain(h: torch.Tensor, index: torch.Tensor,
                      weight: torch.Tensor, y: torch.Tensor
                      ) -> torch.Tensor:
    """``h`` plus each row of ``y`` times its weight, added at its token's
    column: an f32 ``[tokens, hidden]`` accumulator, ``index_add_`` of
    ``y * weight``, and its transpose added to ``h``."""
    acc = h.new_zeros((h.shape[1], h.shape[0]))
    acc.index_add_(0, index, y * weight[:, None])
    return h + acc.T


def moe_combine_cuda(h: torch.Tensor, slot: torch.Tensor,
                     weight: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Launch the combine kernel: a new ``[hidden, tokens]`` float32 tensor
    ``h[:, t] + sum_j weight[slot[t, j]] * y[slot[t, j]]`` over the held
    choices ``slot[t, j] >= 0``, summed in choice order. ``h`` float32
    ``[hidden, tokens]``, ``y`` bf16 ``[rows, hidden]``, ``slot`` int32
    ``[tokens, top]`` and ``weight`` float32 ``[rows]``, all contiguous on
    one card; every slot is -1 or a row of ``y``."""
    if not h.is_cuda:
        raise ValueError("moe_combine_cuda needs CUDA tensors")
    for name, t, dtype, dim in (("h", h, torch.float32, 2),
                                ("y", y, torch.bfloat16, 2),
                                ("slot", slot, torch.int32, 2),
                                ("weight", weight, torch.float32, 1)):
        if t.dtype != dtype:
            raise TypeError(f"moe_combine: {name} must be {dtype}, not "
                            f"{t.dtype}")
        if t.dim() != dim or not t.is_contiguous():
            raise ValueError(f"moe_combine: {name} must be a contiguous "
                             f"{dim}-D tensor, got shape {tuple(t.shape)} "
                             f"and strides {t.stride()}")
        if t.device != h.device:
            raise ValueError(f"moe_combine: {name} is on {t.device}, h on "
                             f"{h.device}")
    hidden, tokens = h.shape
    top = slot.shape[1]
    if (y.shape[1] != hidden or slot.shape[0] != tokens
            or weight.shape[0] != y.shape[0]):
        raise ValueError(f"moe_combine: shapes h {tuple(h.shape)}, y "
                         f"{tuple(y.shape)}, slot {tuple(slot.shape)} and "
                         f"weight {tuple(weight.shape)} do not agree")
    if hidden % 8 or not 1 <= top <= MAX_TOP or y.data_ptr() % 16:
        raise ValueError(f"moe_combine: needs hidden % 8 == 0 (got "
                         f"{hidden}), 1 <= top <= {MAX_TOP} (got {top}) and "
                         f"y 16-byte aligned")
    _build.refuse_grad("moe_combine", h, y, weight)
    out = torch.empty_like(h)
    MOE_COMBINE(h.get_device(), h.data_ptr(), y.data_ptr(), slot.data_ptr(),
                weight.data_ptr(), out.data_ptr(), tokens, hidden, top)
    moe_combine_cuda.launches += 1
    trace.count("moe.combine_kernel")
    return out


moe_combine_cuda.launches = 0
