"""Plain float32 reference of MiMo-V2-Flash's forward, as route ``mimo24``
runs it: one card's share of every layer (the heads and experts it holds),
on weights already cut 2:4. Imports nothing but ``torch``, ``math`` and
``typing``.

Token-major ``[tokens, hidden]`` throughout, float32, TF32 off; each
layer asks ``weight(name, shape)`` for its weights when it runs and drops
them after, so the whole forward fits beside its activations. The names
and shapes are those of the route's weights: ``embed`` / ``head`` ``[vocab,
hidden]``, ``norm``, and per layer ``i``: ``i.attn_norm``, ``i.q``, ``i.k``,
``i.v``, ``i.o``, ``i.sinks`` (window layers), ``i.ffn_norm``; a dense
layer ``i.gate``, ``i.up``, ``i.down``; a MoE layer ``i.router``,
``i.router_bias`` and ``i.e<expert>.gate`` / ``.up`` / ``.down`` for each
held expert. A product's weight is ``[out, in]``.

``spec`` holds the source's ``config.json`` keys at the values run (head
counts are the heads held), ``router_experts`` (how many experts the router
scores) and ``held_experts`` (their ids).

``forward`` may be given the experts each MoE layer chooses (the
program's), and ``route`` / ``moe`` a choice to take where it is a top-k
of the scores within a margin: the program's on its own input to the
layer, as the route judges a layer.

The control (``control=True``) is this reference one precision down:
every product with a weight (projections, FFNs, experts, router, head)
takes its input and weight rounded to fp8 e4m3, accumulates in float32 and
rounds its output to bf16, as the configuration states bf16 in and out.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Tuple

import torch

Weight = Callable[[str, Tuple[int, ...]], torch.Tensor]


def _strict_f32() -> None:
    # a float32 product on the card may otherwise run in TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _product(x: torch.Tensor, w: torch.Tensor, control: bool
             ) -> torch.Tensor:
    """``x [tokens, in] @ w [out, in]^T`` in float32 (the control: fp8
    e4m3 operands, bf16 result)."""
    if control:
        f8 = torch.float8_e4m3fn
        return (x.to(f8).float() @ w.to(f8).float().T).to(
            torch.bfloat16).float()
    return x @ w.float().T


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * \
        w.float()


def rotate(x: torch.Tensor, theta: float, rot: int) -> torch.Tensor:
    """``x [seq, heads, dim]`` with the pairs (j, j + rot/2), j < rot/2,
    of its first ``rot`` dims turned by ``position * theta ** (-2j/rot)``
    (rotate-half RoPE); the other dims as they are."""
    if not rot:
        return x
    half = rot // 2
    pos = torch.arange(x.shape[0], dtype=torch.float64)
    freq = theta ** (-2.0 * torch.arange(half, dtype=torch.float64) / rot)
    ang = (pos[:, None] * freq[None, :])[:, None, :]
    cos, sin = ang.cos().float().to(x.device), ang.sin().float().to(x.device)
    a, b = x[..., :half], x[..., half:rot]
    return torch.cat([a * cos - b * sin, b * cos + a * sin, x[..., rot:]],
                     dim=-1)


def _layer_kind(spec: dict, i: int):
    """``(heads, kv heads, qk dim, v dim, window, sink, theta)``."""
    if spec["hybrid_layer_pattern"][i]:
        return (spec["swa_num_attention_heads"],
                spec["swa_num_key_value_heads"], spec["swa_head_dim"],
                spec["swa_v_head_dim"], spec["sliding_window"],
                spec["add_swa_attention_sink_bias"], spec["swa_rope_theta"])
    return (spec["num_attention_heads"], spec["num_key_value_heads"],
            spec["head_dim"], spec["v_head_dim"], 0,
            spec["add_full_attention_sink_bias"], spec["rope_theta"])


def attention(x: torch.Tensor, spec: dict, i: int, weight: Weight,
              batch: int, control: bool = False) -> torch.Tensor:
    """Layer ``i``'s attention on normed ``x [tokens, hidden]``: the held
    heads' output through the held part of o (a partial sum)."""
    heads, kv, dqk, dv, window, sink, theta = _layer_kind(spec, i)
    hid = spec["hidden_size"]
    q = _product(x, weight(f"{i}.q", (heads * dqk, hid)), control)
    k = _product(x, weight(f"{i}.k", (kv * dqk, hid)), control)
    v = _product(x, weight(f"{i}.v", (kv * dv, hid)), control)
    sinks = weight(f"{i}.sinks", (heads,)).float() if sink else None
    rot = int(spec["partial_rotary_factor"] * dqk)
    seq = x.shape[0] // batch
    group = heads // kv
    pos = torch.arange(seq, device=x.device)
    visible = pos[None, :] <= pos[:, None]
    if window:
        visible &= pos[None, :] > pos[:, None] - window
    outs = []
    for b in range(batch):
        rows = slice(b * seq, (b + 1) * seq)
        qb = rotate(q[rows].view(seq, heads, dqk), theta, rot)
        kb = rotate(k[rows].view(seq, kv, dqk), theta, rot)
        vb = v[rows].view(seq, kv, dv) * spec["attention_value_scale"]
        kb = kb.repeat_interleave(group, dim=1)  # [seq, heads, dqk]
        vb = vb.repeat_interleave(group, dim=1)
        scores = torch.einsum("qhd,khd->hqk", qb, kb) / math.sqrt(dqk)
        scores = scores.masked_fill(~visible, float("-inf"))
        top = scores.amax(-1, keepdim=True)
        if sinks is not None:
            top = torch.maximum(top, sinks[:, None, None])
        e = torch.exp(scores - top)
        den = e.sum(-1, keepdim=True)
        if sinks is not None:
            den = den + torch.exp(sinks[:, None, None] - top)
        outs.append(torch.einsum("hqk,khd->qhd", e / den, vb).reshape(
            seq, heads * dv))
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


def router_scores(x: torch.Tensor, spec: dict, i: int, weight: Weight,
                  control: bool = False
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Layer ``i``'s sigmoid scores ``[tokens, experts]`` over every expert,
    and the same plus the correction bias (what the top-k ranks)."""
    n, hid = spec["router_experts"], spec["hidden_size"]
    scores = torch.sigmoid(_product(x, weight(f"{i}.router", (n, hid)),
                                    control))
    return scores, scores + weight(f"{i}.router_bias", (n,)).float()


def route(x: torch.Tensor, spec: dict, i: int, weight: Weight,
          control: bool = False, prefer: Optional[torch.Tensor] = None,
          tie: float = 0.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each token's selected experts ``[tokens, top]`` and their weights:
    the top ``num_experts_per_tok`` of sigmoid(router logits) + bias over
    every expert, weighted by their scores (over the scores' sum where
    ``norm_topk_prob``). With ``prefer`` (expert ids ``[tokens, top]``), a
    token takes that choice instead where its :func:`violation` is at most
    ``tie``: a top-k within ``tie`` of the scores, as a near-tie resolved
    the other way."""
    scores, biased = router_scores(x, spec, i, weight, control)
    sel = torch.topk(biased, spec["num_experts_per_tok"], dim=-1).indices
    if prefer is not None:
        near = violation(biased, prefer) <= tie
        sel = torch.where(near[:, None], prefer, sel)
    w = torch.gather(scores, 1, sel)
    if spec["norm_topk_prob"]:
        w = w / w.sum(-1, keepdim=True)
    return sel, w


def moe(x: torch.Tensor, spec: dict, i: int, weight: Weight,
        control: bool = False, prefer: Optional[torch.Tensor] = None,
        tie: float = 0.0) -> torch.Tensor:
    """Layer ``i``'s experts on normed ``x``: the held experts' share
    (``prefer`` and ``tie`` as :func:`route` takes them)."""
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
    eps = spec["layernorm_epsilon"]
    h = weight("embed", (vocab, hid))[ids.reshape(-1)].float()
    given = iter(choices) if choices is not None else None
    for i in range(len(spec["hybrid_layer_pattern"])):
        x = rms_norm(h, weight(f"{i}.attn_norm", (hid,)), eps)
        h = h + attention(x, spec, i, weight, batch, control)
        x = rms_norm(h, weight(f"{i}.ffn_norm", (hid,)), eps)
        if spec["moe_layer_freq"][i]:
            prefer = next(given) if given is not None else None
            h = h + moe(x, spec, i, weight, control, prefer, math.inf)
        else:
            h = h + dense_ffn(x, spec, i, weight, control)
    x = rms_norm(h, weight("norm", (hid,)), eps)
    del h
    last = x[seq - 1::seq]
    logits = _product(last, weight("head", (vocab, hid)), control)
    return x.T.contiguous(), logits

