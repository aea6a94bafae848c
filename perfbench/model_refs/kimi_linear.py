"""Plain float32 reference of Kimi Linear's forward (Kimi-Linear-48B-A3B),
as route ``kimilinear24`` runs it: one card's share of every layer (every
head, the experts it holds), on weights already cut 2:4. Imports nothing
but ``torch``, ``math`` and ``typing``.

It follows the published forward (the source's ``config.json`` and the
paper, arXiv:2510.26692). The layers that ``linear_attn_config`` lists in
``kda_layers`` (1-indexed) are Kimi Delta Attention, per head (``head_dim``
d = 128 for q, k and v) and token::

    q~, k~, v = SiLU(conv4(W_q x)), SiLU(conv4(W_k x)), SiLU(conv4(W_v x))
    q, k      = q~ * rsqrt(||q~||^2 + 1e-6), k~ * rsqrt(||k~||^2 + 1e-6)
    g_t       = -exp(A_log[h]) * softplus(W_fb W_fa x_t + dt_bias)
    beta_t    = sigmoid(W_b x_t)[h]
    S_t       = (I - beta_t k_t k_t^T) Diag(exp(g_t)) S_{t-1}
                + beta_t k_t v_t^T                  # S_0 = 0 each sequence
    o_t       = S_t^T q_t * d ** -0.5
    y_t       = RMSNorm_d(o_t) * w_onorm * sigmoid(W_gb W_ga x_t)[head]
    out       = W_o concat_heads(y)

(conv4: a causal depthwise convolution of width ``short_conv_kernel_size``
along each sequence's positions, zeros before position 0, no bias),
computed here as that token recurrence itself, one position at a time,
every sequence and head at once. The other layers (``full_attn_layers``)
are multi-head latent attention without a q latent (``q_lora_rank`` null)
and without RoPE (``mla_use_nope``)::

    [q_nope | q_pe] = W_q x;  [c_kv, k_pe] = W_kva x
    [k_nope | v]    = W_kvb RMSNorm(c_kv);  k = [k_nope, k_pe]
    out = W_o concat(softmax(q k^T * (nope + rope) ** -0.5, causal) v)

(k_pe shared by every head, nothing rotated). The first
``first_k_dense_replace`` layers have a dense SwiGLU FFN, the others the
MoE layer: sigmoid scores over every routed expert, the top
``num_experts_per_token`` of score + correction bias (``num_expert_group``
1: no group limit), weights the chosen scores over their sum
(``moe_renormalize``) times ``routed_scaling_factor``, plus
``num_shared_experts`` shared experts' SwiGLU on every token. Pre-norm
blocks, RMSNorm eps ``rms_norm_eps``, a final RMSNorm before the head.

Departures: only the held experts are computed (their share, with the
shared expert whole, goes on to the next layer), there is no exchange
between cards; the output gate's second factor ``W_gb`` has no bias (the
source's is zero at initialisation); decode through the recurrent state
and the latent cache is not here.

Token-major ``[tokens, hidden]`` throughout, float32, TF32 off; each
layer asks ``weight(name, shape)`` for its weights when it runs. Names
and shapes are the route's: ``embed`` / ``head`` ``[vocab, hidden]``,
``norm``, per layer ``i``: ``i.attn_norm``; a KDA layer ``i.q``, ``i.k``,
``i.v`` ``[heads * d, hidden]``, ``i.o``, ``i.f_a`` / ``i.g_a`` ``[d,
hidden]``, ``i.f_b`` / ``i.g_b`` ``[heads * d, d]``, ``i.b`` ``[heads,
hidden]``, ``i.A_log`` ``[heads]``, ``i.dt_bias`` ``[heads * d]``,
``i.q_conv`` / ``i.k_conv`` / ``i.v_conv`` ``[heads * d, width]``,
``i.o_norm`` ``[d]``; an MLA layer ``i.q``, ``i.kv_a``, ``i.kv_a_norm``,
``i.kv_b``, ``i.o``; ``i.ffn_norm``; a dense layer ``i.gate``, ``i.up``,
``i.down``; a MoE layer ``i.router``, ``i.router_bias``,
``i.e<expert>.gate`` / ``.up`` / ``.down`` for each held expert and
``i.shared.gate`` / ``.up`` / ``.down``. A product's weight is ``[out,
in]``.

``spec`` holds the source's ``config.json`` keys at the values run,
``router_experts`` (how many experts the router scores) and
``held_experts`` (their ids). ``forward`` may be given the experts each
MoE layer chooses (the program's), and ``route`` / ``moe`` a choice to
take where it is within a margin of the top-k (:func:`violation`).

The control (``control=True``) is this reference one precision down:
every product with a weight takes its input and weight rounded to fp8
e4m3, accumulates in float32 and rounds its output to bf16, as the
configuration states bf16 in and out.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Tuple

import torch

Weight = Callable[[str, Tuple[int, ...]], torch.Tensor]
L2_EPS = 1e-6


def _strict_f32() -> None:
    # a float32 product on the card may otherwise run in TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _product(x: torch.Tensor, w: torch.Tensor, control: bool
             ) -> torch.Tensor:
    """``x [tokens, in] @ w [out, in]^T`` in float32 (the control: fp8
    e4m3 operands, bf16 result), TF32 off for this and what follows."""
    _strict_f32()
    if control:
        f8 = torch.float8_e4m3fn
        return (x.to(f8).float() @ w.to(f8).float().T).to(
            torch.bfloat16).float()
    return x @ w.float().T


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * \
        w.float()


def is_kda(spec: dict, i: int) -> bool:
    """Layer ``i`` (0-indexed) is a KDA layer: ``kda_layers`` lists it,
    1-indexed."""
    return i + 1 in spec["linear_attn_config"]["kda_layers"]


def is_moe(spec: dict, i: int) -> bool:
    """Layer ``i`` is a MoE layer: past the leading dense ones, at the
    layer frequency."""
    return i >= spec["first_k_dense_replace"] and \
        i % spec["moe_layer_freq"] == 0


def short_conv(x: torch.Tensor, w: torch.Tensor, batch: int) -> torch.Tensor:
    """SiLU of the causal depthwise convolution of ``x [tokens, channels]``
    by ``w [channels, width]`` along each sequence's positions, zeros
    before position 0."""
    t, ch = x.shape
    seq, width = t // batch, w.shape[1]
    xs = torch.nn.functional.pad(x.view(batch, seq, ch),
                                 (0, 0, width - 1, 0))
    y = torch.zeros((batch, seq, ch), dtype=x.dtype, device=x.device)
    for j in range(width):
        y = y + xs[:, j:j + seq] * w[:, j].float()
    return torch.nn.functional.silu(y).view(t, ch)


def l2_norm(x: torch.Tensor, heads: int) -> torch.Tensor:
    """Each head's dims of ``x [tokens, heads * d]`` times ``rsqrt(sum
    x^2 + 1e-6)``."""
    xh = x.view(x.shape[0], heads, -1)
    return (xh * torch.rsqrt(xh.square().sum(-1, keepdim=True) + L2_EPS)
            ).view(x.shape)


def delta_rule(q, k, v, g, beta, batch: int, scale: float) -> torch.Tensor:
    """The gated delta rule, token by token: ``q``, ``k``, ``v``, ``g``
    ``[tokens, heads, d]``, ``beta [tokens, heads]``; every sequence and
    head at once, the state ``[batch, heads, d, d]`` zero at each
    sequence's start. Returns ``o [tokens, heads, d]``."""
    t, heads, d = q.shape
    seq = t // batch

    def seqs(x):
        return x.view(batch, seq, *x.shape[1:])

    qs, ks, vs, gs, bs = (seqs(x) for x in (q, k, v, g, beta))
    state = q.new_zeros((batch, heads, d, v.shape[-1]))
    out = torch.empty_like(seqs(v))
    for i in range(seq):
        state = state * gs[:, i, :, :, None].exp()
        kt = ks[:, i]
        u = bs[:, i, :, None] * (vs[:, i] - torch.einsum("bhd,bhdv->bhv",
                                                         kt, state))
        state = state + kt[..., None] * u[:, :, None, :]
        out[:, i] = torch.einsum("bhd,bhdv->bhv", qs[:, i], state) * scale
    return out.view(t, heads, -1)


def kda(x: torch.Tensor, spec: dict, i: int, weight: Weight, batch: int,
        control: bool = False) -> torch.Tensor:
    """Layer ``i``'s Kimi Delta Attention on normed ``x [tokens, hidden]``,
    every head."""
    lin = spec["linear_attn_config"]
    heads, d, width = (lin["num_heads"], lin["head_dim"],
                       lin["short_conv_kernel_size"])
    hid, eps, t = spec["hidden_size"], spec["rms_norm_eps"], x.shape[0]

    def proj(name, shape, inp=x):
        return _product(inp, weight(f"{i}.{name}", shape), control)

    qkv = {}
    for n in "qkv":
        y = proj(n, (heads * d, hid))
        qkv[n] = short_conv(y, weight(f"{i}.{n}_conv", (heads * d, width)),
                            batch)
    q, k = l2_norm(qkv["q"], heads), l2_norm(qkv["k"], heads)
    f = proj("f_b", (heads * d, d), proj("f_a", (d, hid)))
    a_log = weight(f"{i}.A_log", (heads,)).float()
    dt_bias = weight(f"{i}.dt_bias", (heads * d,)).float()
    g = -a_log.exp()[:, None] * torch.nn.functional.softplus(
        (f + dt_bias).view(t, heads, d))
    beta = torch.sigmoid(proj("b", (heads, hid)))
    o = delta_rule(q.view(t, heads, d), k.view(t, heads, d),
                   qkv["v"].view(t, heads, d), g, beta, batch, d ** -0.5)
    gate = proj("g_b", (heads * d, d), proj("g_a", (d, hid)))
    y = rms_norm(o, weight(f"{i}.o_norm", (d,)), eps) * torch.sigmoid(
        gate.view(t, heads, d))
    return proj("o", (hid, heads * d), y.reshape(t, heads * d))


def mla(x: torch.Tensor, spec: dict, i: int, weight: Weight, batch: int,
        control: bool = False) -> torch.Tensor:
    """Layer ``i``'s NoPE multi-head latent attention without a q latent
    on normed ``x [tokens, hidden]``, every head."""
    hid, heads = spec["hidden_size"], spec["num_attention_heads"]
    nope, rot = spec["qk_nope_head_dim"], spec["qk_rope_head_dim"]
    dv, eps, kvl = spec["v_head_dim"], spec["rms_norm_eps"], \
        spec["kv_lora_rank"]
    q = _product(x, weight(f"{i}.q", (heads * (nope + rot), hid)), control)
    kv = _product(x, weight(f"{i}.kv_a", (kvl + rot, hid)), control)
    latent, k_pe = kv[:, :kvl], kv[:, kvl:]
    latent = rms_norm(latent, weight(f"{i}.kv_a_norm", (kvl,)), eps)
    kv = _product(latent, weight(f"{i}.kv_b", (heads * (nope + dv), kvl)),
                  control)
    seq = x.shape[0] // batch
    scale = (nope + rot) ** -0.5
    pos = torch.arange(seq, device=x.device)
    visible = pos[None, :] <= pos[:, None]
    outs = []
    for b in range(batch):
        rows = slice(b * seq, (b + 1) * seq)
        qb = q[rows].view(seq, heads, nope + rot)
        kvb = kv[rows].view(seq, heads, nope + dv)
        pe = k_pe[rows].view(seq, 1, rot).expand(seq, heads, rot)
        kb = torch.cat([kvb[..., :nope], pe], dim=-1)
        scores = torch.einsum("qhd,khd->hqk", qb, kb) * scale
        scores = scores.masked_fill(~visible, float("-inf"))
        p = torch.softmax(scores, dim=-1)
        del scores
        outs.append(torch.einsum("hqk,khd->qhd", p, kvb[..., nope:])
                    .reshape(seq, heads * dv))
    o = torch.cat(outs)
    return _product(o, weight(f"{i}.o", (hid, heads * dv)), control)


def _swiglu(x, gate, up, down, control):
    g = _product(x, gate, control)
    u = _product(x, up, control)
    return _product(torch.nn.functional.silu(g) * u, down, control)


def dense_ffn(x: torch.Tensor, spec: dict, i: int, weight: Weight,
              control: bool = False) -> torch.Tensor:
    hid, width = spec["hidden_size"], spec["intermediate_size"]
    return _swiglu(x, weight(f"{i}.gate", (width, hid)),
                   weight(f"{i}.up", (width, hid)),
                   weight(f"{i}.down", (hid, width)), control)


def router_scores(x: torch.Tensor, spec: dict, i: int, weight: Weight,
                  control: bool = False
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Layer ``i``'s sigmoid scores ``[tokens, experts]`` over every
    routed expert, and the same plus the correction bias (what the top-k
    ranks)."""
    n, hid = spec["router_experts"], spec["hidden_size"]
    scores = torch.sigmoid(_product(x, weight(f"{i}.router", (n, hid)),
                                    control))
    return scores, scores + weight(f"{i}.router_bias", (n,)).float()


def violation(biased: torch.Tensor, choice: torch.Tensor) -> torch.Tensor:
    """How far ``choice [tokens, top]`` is from being a top-k of ``biased
    [tokens, experts]``, per token: the largest value left out less the
    smallest taken; at most 0 where it is one, infinite where it names an
    expert twice."""
    taken = torch.gather(biased, 1, choice)
    left = biased.scatter(1, choice, float("-inf"))
    ids = choice.sort(-1).values
    twice = (ids[:, 1:] == ids[:, :-1]).any(-1)
    return (left.amax(-1) - taken.amin(-1)).masked_fill(twice, math.inf)


def route(x: torch.Tensor, spec: dict, i: int, weight: Weight,
          control: bool = False, prefer: Optional[torch.Tensor] = None,
          tie: float = 0.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each token's selected experts ``[tokens, top]`` and their weights:
    the top ``num_experts_per_token`` of score + bias, weighted by their
    scores over the scores' sum (``moe_renormalize``) times
    ``routed_scaling_factor``. With ``prefer`` (expert ids ``[tokens,
    top]``), a token takes that choice instead where its
    :func:`violation` is at most ``tie``: a near-tie resolved the other
    way."""
    scores, biased = router_scores(x, spec, i, weight, control)
    sel = torch.topk(biased, spec["num_experts_per_token"], dim=-1).indices
    if prefer is not None:
        near = violation(biased, prefer) <= tie
        sel = torch.where(near[:, None], prefer, sel)
    w = torch.gather(scores, 1, sel)
    if spec["moe_renormalize"]:
        w = w / w.sum(-1, keepdim=True)
    return sel, w * (spec["routed_scaling_factor"] or 1.0)


def routed(x: torch.Tensor, spec: dict, i: int, weight: Weight,
           control: bool = False, prefer: Optional[torch.Tensor] = None,
           tie: float = 0.0) -> torch.Tensor:
    """Layer ``i``'s held routed experts on normed ``x``: their weighted
    share (``prefer`` and ``tie`` as :func:`route` takes them)."""
    sel, w = route(x, spec, i, weight, control, prefer, tie)
    hid, width = spec["hidden_size"], spec["moe_intermediate_size"]
    out = torch.zeros_like(x)
    for e in spec["held_experts"]:
        chosen = sel == e
        tokens = chosen.any(-1).nonzero().squeeze(-1)
        if tokens.numel() == 0:
            continue
        we = (w * chosen).sum(-1)[tokens]
        y = _swiglu(x[tokens], weight(f"{i}.e{e}.gate", (width, hid)),
                    weight(f"{i}.e{e}.up", (width, hid)),
                    weight(f"{i}.e{e}.down", (hid, width)), control)
        out[tokens] += we[:, None] * y
    return out


def shared_expert(x: torch.Tensor, spec: dict, i: int, weight: Weight,
                  control: bool = False) -> torch.Tensor:
    """Layer ``i``'s shared experts on normed ``x``: a SwiGLU of
    ``num_shared_experts`` experts' width on every token."""
    hid = spec["hidden_size"]
    width = spec["moe_intermediate_size"] * spec["num_shared_experts"]
    return _swiglu(x, weight(f"{i}.shared.gate", (width, hid)),
                   weight(f"{i}.shared.up", (width, hid)),
                   weight(f"{i}.shared.down", (hid, width)), control)


def moe(x: torch.Tensor, spec: dict, i: int, weight: Weight,
        control: bool = False, prefer: Optional[torch.Tensor] = None,
        tie: float = 0.0) -> torch.Tensor:
    """Layer ``i``'s MoE on normed ``x``: the held routed experts' share
    and the shared expert."""
    return routed(x, spec, i, weight, control, prefer, tie) + \
        shared_expert(x, spec, i, weight, control)


def forward(ids: torch.Tensor, spec: dict, weight: Weight,
            control: bool = False,
            choices: Optional[Sequence[torch.Tensor]] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``ids [batch, seq]`` to the final-norm hidden state of every token,
    feature-major ``[hidden, batch * seq]``, and each sequence's last
    logits ``[batch, vocab]``; float32. ``choices``, one ``[tokens, top]``
    a MoE layer, are the experts each layer takes (weighted by this
    forward's own scores), whatever its own top-k."""
    _strict_f32()
    batch, seq = ids.shape
    hid, vocab = spec["hidden_size"], spec["vocab_size"]
    eps = spec["rms_norm_eps"]
    h = weight("embed", (vocab, hid))[ids.reshape(-1)].float()
    given = iter(choices) if choices is not None else None
    for i in range(spec["num_hidden_layers"]):
        x = rms_norm(h, weight(f"{i}.attn_norm", (hid,)), eps)
        attend = kda if is_kda(spec, i) else mla
        h = h + attend(x, spec, i, weight, batch, control)
        x = rms_norm(h, weight(f"{i}.ffn_norm", (hid,)), eps)
        if is_moe(spec, i):
            prefer = next(given) if given is not None else None
            h = h + moe(x, spec, i, weight, control, prefer, math.inf)
        else:
            h = h + dense_ffn(x, spec, i, weight, control)
    x = rms_norm(h, weight("norm", (hid,)), eps)
    del h
    last = x[seq - 1::seq]
    logits = _product(last, weight("head", (vocab, hid)), control)
    return x.T.contiguous(), logits
