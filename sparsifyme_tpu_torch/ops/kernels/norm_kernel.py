"""Wrapper of the RMSNorm kernel (``csrc/rms_norm.cu``) beside its plain
PyTorch version.

The kernel replaces no TPU kernel: the JAX package has no transformer. It
is every RMSNorm of :mod:`~..models.moe_transformer` and
:mod:`~..models.mla`: ``h [hidden, tokens]`` feature-major, float32 (the
residual stream) or bf16 (a latent), normed by the bf16 weight ``w
[hidden]`` into bf16, feature-major ``[hidden, tokens]``, token-major
``[tokens, hidden]`` or both from one read of h. The plain version is the
four PyTorch calls the model normed with before the kernel (a float32
norm, two float32 multiplies and the cast), and the transpose of their
result for the token-major layout.

The norm is bound by device-memory bytes (h read once, each output
written once); the source says how the kernel reads h once.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ... import _build
from ...utils import trace

# (h, w, out, out_t, hidden, tokens, in_bf16, block_rows, eps, device,
#  stream)
RMS_NORM = _build.Entry("rms_norm", "rms_norm_launch",
                        "pppp" "iiii" "f" "i" "p")
CLUSTER = 8  # blocks of a cluster the plan aims at
MIN_ROWS = 256  # features a block holds, at least (smaller blocks are slower)
BLOCK_BYTES = 75 * 1024  # shared memory a block takes, at most: 3 an SM
MAX_CLUSTER = 16  # blocks of a cluster (Hopper's non-portable most)


def norm_plan(hidden: int, itemsize: int, token: bool) -> Tuple[int, int]:
    """``(cluster, rows)``: the blocks of the cluster that shares a strip of
    tokens and the features each holds, a multiple of 64. A block holds 128
    bytes of each of its rows (a strip of ``128 // itemsize`` tokens) and,
    where ``token``, out_t's two tiles; it takes the fewest rows of which
    :data:`CLUSTER` blocks cover ``hidden``, at least :data:`MIN_ROWS` and
    at most what :data:`BLOCK_BYTES` holds, and the rows are then spread
    evenly over the blocks that cover ``hidden``. float32 at 4096 -> (8,
    512); at 7168 -> (13, 576), with out_t (14, 512); bf16 at 1536 -> (6,
    256), at 512 -> (2, 256)."""
    tile = 2 * 64 * (128 // itemsize) * 2 if token else 0
    most = (BLOCK_BYTES - tile) // 128 // 64 * 64
    rows = min(most, max(MIN_ROWS, 64 * -(-hidden // (64 * CLUSTER))))
    cluster = -(-hidden // rows)
    if cluster > MAX_CLUSTER:
        raise ValueError(f"rms_norm: hidden {hidden} > {MAX_CLUSTER * rows}, "
                         "the most a cluster of the kernel holds here")
    return cluster, 64 * -(-hidden // (64 * cluster))


def rms_norm_plain(h: torch.Tensor, w: torch.Tensor, eps: float
                   ) -> torch.Tensor:
    """RMSNorm of float32 ``h [hidden, tokens]`` over dim 0 by ``w``, bf16
    out: ``vector_norm``, ``h * rsqrt(ms + eps)``, ``* w`` and the cast, in
    float32."""
    ms = torch.linalg.vector_norm(h, dim=0, keepdim=True).square_().div_(
        h.shape[0])
    return (h * ms.add_(eps).rsqrt_()).mul_(w.float()[:, None]).to(
        torch.bfloat16)


def rms_norm_cuda(h: torch.Tensor, w: torch.Tensor, eps: float,
                  out: Optional[torch.Tensor] = None,
                  out_t: Optional[torch.Tensor] = None) -> None:
    """Launch the RMSNorm kernel: ``bf16((h[f, t] * r[t]) * w[f])``, ``r[t]
    = rsqrt(sum_f h[f, t]^2 / hidden + eps)``, into ``out [hidden,
    tokens]`` and/or ``out_t [tokens, hidden]`` (bf16, contiguous; None
    leaves that layout out, one at least). ``h`` float32 or bf16
    ``[hidden, tokens]`` and ``w`` bf16 ``[hidden]``, contiguous on one
    card; ``hidden % 8 == 0`` and within what :func:`norm_plan` holds
    (8192 in float32)."""
    if not h.is_cuda:
        raise ValueError("rms_norm_cuda needs CUDA tensors")
    if h.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"rms_norm: h must be float32 or bfloat16, not "
                        f"{h.dtype}")
    if w.dtype != torch.bfloat16:
        raise TypeError(f"rms_norm: w must be torch.bfloat16, not {w.dtype}")
    if out is None and out_t is None:
        raise ValueError("rms_norm: give out, out_t or both")
    if h.dim() != 2:
        raise ValueError(f"rms_norm: h must be 2-D [hidden, tokens], got "
                         f"shape {tuple(h.shape)}")
    hidden, tokens = h.shape
    for name, t, shape in (("h", h, (hidden, tokens)), ("w", w, (hidden,)),
                           ("out", out, (hidden, tokens)),
                           ("out_t", out_t, (tokens, hidden))):
        if t is None:
            continue
        if tuple(t.shape) != shape:
            raise ValueError(f"rms_norm: {name} must have shape {shape}, "
                             f"got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"rms_norm: {name} must be contiguous, got "
                             f"strides {t.stride()}")
        if t.device != h.device:
            raise ValueError(f"rms_norm: {name} is on {t.device}, h on "
                             f"{h.device}")
        if name.startswith("out") and (t.dtype != torch.bfloat16
                                       or t.data_ptr() % 16):
            raise ValueError(f"rms_norm: {name} must be bf16 and 16-byte "
                             "aligned")
    if hidden % 8:
        raise ValueError(f"rms_norm: needs hidden % 8 == 0, got {hidden}")
    _, rows = norm_plan(hidden, h.element_size(), out_t is not None)
    _build.refuse_grad("rms_norm", h, w)
    RMS_NORM(h.get_device(), h.data_ptr(), w.data_ptr(), _build.ptr(out),
             _build.ptr(out_t), hidden, tokens,
             int(h.dtype == torch.bfloat16), rows, eps)
    rms_norm_cuda.launches += 1
    trace.count("norm.kernel")


rms_norm_cuda.launches = 0
