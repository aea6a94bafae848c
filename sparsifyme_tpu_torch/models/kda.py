"""Kimi Delta Attention (KDA), the linear-attention block of Kimi Linear
(arXiv:2510.26692), as one card's copy of a layer, on 2:4-pruned weights
and feature-major activations ``[features, tokens]`` like the rest of
:mod:`.moe_transformer`.

Per token, per head (``linear_attn_config``: ``num_heads`` 32 heads of
``head_dim`` 128 for q, k and v; ``short_conv_kernel_size`` 4)::

    q~, k~, v = SiLU(conv4(W_q x)), SiLU(conv4(W_k x)), SiLU(conv4(W_v x))
    q, k      = q~ / ||q~||, k~ / ||k~||             # per head
    g_t       = -exp(A_log[h]) * softplus(W_fb W_fa x_t + dt_bias)
    beta_t    = sigmoid(W_b x_t)[h]
    S_t       = (I - beta_t k_t k_t^T) Diag(exp(g_t)) S_{t-1}
                + beta_t k_t v_t^T                     # S_0 = 0 a sequence
    o_t       = S_t^T q_t * d ** -0.5
    y_t       = RMSNorm_d(o_t) * w_onorm * sigmoid(W_gb W_ga x_t)[head]
    out       = W_o concat_heads(y)

``conv4`` is a causal depthwise convolution along each sequence's
positions, zeros before position 0, no bias; the L2 norm is ``x *
rsqrt(sum x^2 + 1e-6)``. The block is pre-norm: ``h + out(RMSNorm(h))``.

q, k and v are one 2:4 weight of three times the rows (the same cut as
three), o another (:func:`.moe_transformer.sparse_weight`); the low-rank
gate factors ``f_a``, ``g_a`` and ``b`` are one dense bf16 weight, ``f_b``
and ``g_b`` dense bf16, as the router stays dense. On a card the rest is
hand-written kernels (:mod:`~..ops.kernels.kda_kernel`): the convolution,
SiLU and the q and k L2 norms in one pass; the log-decay in one; the
recurrence, chunked (bf16 q, k, v, float32 decay and beta, the state
float32, bf16 o); the gated output norm in one pass. beta's sigmoid and
the low-rank products stay PyTorch's. On the CPU each kernel's plain
version runs (float32 inside, the recurrence as its plain chunked form).

:func:`kda_attention` records ``sparsifyme.kda`` with the phases ``proj``
(the input norm, the qkv product, the gates' low-rank products), ``conv``
(convolution, SiLU, the L2 norms), ``gate`` (decay and beta), ``chunk``
(the recurrence), ``norm`` (the gated output norm) and ``out`` (the o
product and the residual add); it counts ``kda.tokens`` (tokens x heads
through the recurrence), and the kernels ``kda.kernel``, ``kda.conv``,
``kda.decay`` and ``kda.gate_norm`` a launch each. It enters
``products()`` around its 2:4 products (qkv; o) and ``core()`` around the
recurrence.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Tuple

import torch

from .. import _build
from ..ops.kernels import kda_kernel
from ..utils import trace
from . import moe_transformer as mt

BF16 = torch.bfloat16
L2_EPS = 1e-6  # the q and k norms' epsilon
PRODUCTS = ("qkv", "o")
# the block's parts, as weight(name) gives them: products [out, in]
SHAPES = ("q", "k", "v", "o", "f_a", "f_b", "g_a", "g_b", "b", "A_log",
          "dt_bias", "q_conv", "k_conv", "v_conv", "o_norm")


@dataclasses.dataclass
class Kda:
    norm: torch.Tensor  # [hidden]
    qkv: mt.Linear  # [3 * heads * d, hidden]: q rows, k rows, v rows
    o: mt.Linear  # [hidden, heads * d]
    low: torch.Tensor  # [2 * d + heads, hidden] bf16: f_a, g_a, b rows
    f_b: torch.Tensor  # [heads * d, d] bf16
    g_b: torch.Tensor  # [heads * d, d] bf16
    conv: torch.Tensor  # [3 * heads * d, width] bf16: q, k, v channels
    a_log: torch.Tensor  # [heads] float32
    dt_bias: torch.Tensor  # [heads * d] float32
    o_norm: torch.Tensor  # [d]
    heads: int

    PRODUCTS = PRODUCTS  # its 2:4 weights, as moe_transformer's blocks


def dims(config) -> Tuple[int, int, int]:
    """``(heads, head_dim, conv width)`` of the configuration's KDA
    layers (its ``linear_attn_config``)."""
    c = dict(config.linear_attn_config)
    return c["num_heads"], c["head_dim"], c["short_conv_kernel_size"]


def weight_shape(config, part: str) -> Tuple[int, ...]:
    """The shape of part ``part`` (one of :data:`SHAPES`) of a KDA layer."""
    hid = config.hidden_size
    heads, d, width = dims(config)
    return {"q": (heads * d, hid), "k": (heads * d, hid),
            "v": (heads * d, hid), "o": (hid, heads * d),
            "f_a": (d, hid), "g_a": (d, hid), "b": (heads, hid),
            "f_b": (heads * d, d), "g_b": (heads * d, d),
            "A_log": (heads,), "dt_bias": (heads * d,),
            "q_conv": (heads * d, width), "k_conv": (heads * d, width),
            "v_conv": (heads * d, width), "o_norm": (d,)}[part]


def init_kda(config, w: Callable[[str], torch.Tensor], layer: int) -> Kda:
    """Layer ``layer``'s block from ``w(name)``, the dense tensor of that
    name (``<layer>.<part>``) and :func:`weight_shape`'s shape: q, k and v
    stacked and pruned as one 2:4 weight, o another; the gate factors, the
    convolution's weights and the norms as given, ``A_log`` and
    ``dt_bias`` float32."""
    i = layer
    heads, _, _ = dims(config)
    qkv = mt.sparse_weight(torch.cat([w(f"{i}.q"), w(f"{i}.k"),
                                      w(f"{i}.v")]))
    return Kda(norm=w(f"{i}.attn_norm"), qkv=qkv,
               o=mt.sparse_weight(w(f"{i}.o")),
               low=torch.cat([w(f"{i}.f_a"), w(f"{i}.g_a"), w(f"{i}.b")]),
               f_b=w(f"{i}.f_b"), g_b=w(f"{i}.g_b"),
               conv=torch.cat([w(f"{i}.q_conv"), w(f"{i}.k_conv"),
                               w(f"{i}.v_conv")]).to(BF16),
               a_log=w(f"{i}.A_log").float(),
               dt_bias=w(f"{i}.dt_bias").float(),
               o_norm=w(f"{i}.o_norm"), heads=heads)


def short_conv(x: torch.Tensor, w: torch.Tensor, batch: int, normed: int,
               d: int) -> torch.Tensor:
    """SiLU of the causal depthwise convolution of feature-major ``x
    [channels, batch * seq]`` bf16 along each sequence's positions by ``w
    [channels, width]`` (zeros before position 0), the first ``normed``
    rows (q's and k's) then L2-normed per head of ``d`` rows and token
    (``x * rsqrt(sum x^2 + 1e-6)``); bf16 out. The conv kernel on a card,
    its plain version on the CPU."""
    if _build.use_kernel(x):
        return kda_kernel.kda_conv_cuda(x, w, batch, normed, L2_EPS)
    return kda_kernel.kda_conv_plain(x, w, batch, normed, L2_EPS, d)


def gates(p: Kda, low: torch.Tensor, d: int
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """From the low-rank products ``low [2 * d + heads, tokens]`` (bf16):
    the log-decay ``g = -exp(A_log) * softplus(W_fb f + dt_bias)`` float32
    ``[heads * d, tokens]`` (the decay kernel on a card), ``beta =
    sigmoid(W_b x)`` float32 ``[heads, tokens]`` and the output gate's
    input ``W_gb W_ga x`` bf16 ``[heads * d, tokens]``."""
    f = torch.matmul(p.f_b, low[:d])
    if _build.use_kernel(f):
        g = kda_kernel.kda_decay_cuda(f, p.a_log, p.dt_bias)
    else:
        g = kda_kernel.kda_decay_plain(f, p.a_log, p.dt_bias)
    beta = torch.sigmoid(low[2 * d:].float())
    gate = torch.matmul(p.g_b, low[d:2 * d])
    return g, beta, gate


def recurrence(q, k, v, g, beta, batch: int) -> torch.Tensor:
    """The chunked recurrence, bf16 ``o [heads * d, tokens]``: the kernel
    on a card, its plain chunked form (float32) on the CPU; counts
    ``kda.tokens`` (tokens x heads)."""
    trace.count("kda.tokens", beta.numel())
    if _build.use_kernel(q):
        return kda_kernel.kda_chunk_cuda(q, k, v, g, beta, batch)
    return kda_kernel.kda_chunk_plain(q, k, v, g, beta, batch).to(BF16)


def gated_norm(o: torch.Tensor, w: torch.Tensor, gate: torch.Tensor,
               eps: float) -> torch.Tensor:
    """``RMSNorm_d(o) * w * sigmoid(gate)`` per head and token (d =
    ``w``'s length), float32 inside, bf16 ``[heads * d, tokens]`` out: the
    gated norm kernel on a card, its plain version on the CPU."""
    if _build.use_kernel(o):
        return kda_kernel.kda_gate_norm_cuda(o, gate, w, eps)
    return kda_kernel.kda_gate_norm_plain(o, gate, w, eps)


def kda_attention(p: Kda, h: torch.Tensor, config, batch: int,
                  products: mt.Products = contextlib.nullcontext,
                  core: mt.Products = contextlib.nullcontext
                  ) -> torch.Tensor:
    """``h + KDA(RMSNorm(h))`` for ``batch`` sequences of equal length, ``h
    [hidden, tokens]`` float32: every head. ``products()`` is entered
    around the 2:4 products (qkv; o), ``core()`` around the recurrence."""
    call = trace.begin("sparsifyme.kda", "proj")
    try:
        eps = config.layernorm_epsilon
        heads, d, _ = dims(config)
        x = mt.rms_norm(h, p.norm, eps)
        with products():
            qkv = mt.linear(p.qkv, x)
        low = torch.matmul(p.low, x)
        trace.mark("conv")
        qkv = short_conv(qkv, p.conv, batch, 2 * heads * d, d)
        q, k, v = (qkv[i * heads * d:(i + 1) * heads * d] for i in range(3))
        trace.mark("gate")
        g, beta, gate = gates(p, low, d)
        trace.mark("chunk")
        with core():
            o = recurrence(q, k, v, g, beta, batch)
        trace.mark("norm")
        y = gated_norm(o, p.o_norm, gate, eps)
        trace.mark("out")
        with products():
            y = mt.linear(p.o, y)
        return h + y
    finally:
        if call:
            trace.end(call)
