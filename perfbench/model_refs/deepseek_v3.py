"""Plain float32 reference of DeepSeek-V3's forward, as route ``dsv3mla24``
runs it: one card's share of every layer (the heads and experts it holds),
on weights already cut 2:4. Imports nothing but ``torch``, ``math`` and
``typing``.

It follows the published forward (the source's ``config.json`` and its
inference code, arXiv:2412.19437): every layer multi-head latent attention
(q through a low-rank latent and its RMSNorm; k and v from a 512-wide
latent and its RMSNorm, plus one 64-wide rope key shared by the heads;
RoPE with YaRN's frequencies on the interleaved pairs (2j, 2j + 1) of the
rope dims; softmax scale ``(nope + rope) ** -0.5`` times YaRN's mscale
squared; causal), the first ``first_k_dense_replace`` layers a dense
SwiGLU FFN, the others the MoE layer: sigmoid scores over every routed
expert, a group's score the sum of its two highest score + bias, the top
``topk_group`` groups kept, the top ``num_experts_per_tok`` of score +
bias chosen within them, weights the chosen scores over their sum times
``routed_scaling_factor``, plus a shared expert on every token.
Departures: the multi-token-prediction module is not run; only the held
heads and experts are computed (the o projection's partial sum over the
held heads and the held experts' share go on to the next layer, with the
shared expert whole); there is no exchange between cards.

Token-major ``[tokens, hidden]`` throughout, float32, TF32 off; each
layer asks ``weight(name, shape)`` for its weights when it runs and drops
them after. Names and shapes are the route's: ``embed`` / ``head``
``[vocab, hidden]``, ``norm``, and per layer ``i``: ``i.attn_norm``,
``i.q_a``, ``i.q_a_norm``, ``i.q_b``, ``i.kv_a``, ``i.kv_a_norm``,
``i.kv_b``, ``i.o``, ``i.ffn_norm``; a dense layer ``i.gate``, ``i.up``,
``i.down``; a MoE layer ``i.router``, ``i.router_bias``,
``i.e<expert>.gate`` / ``.up`` / ``.down`` for each held expert and
``i.shared.gate`` / ``.up`` / ``.down``. A product's weight is ``[out,
in]``.

``spec`` holds the source's ``config.json`` keys at the values run (head
counts are the heads held), ``router_experts`` (how many experts the router
scores) and ``held_experts`` (their ids).

``forward`` may be given the experts each MoE layer chooses (the
program's), and ``route`` / ``moe`` a choice to take where it is within a
margin of the group-limited top-k (:func:`violation`): the program's on
its own input to the layer, as the route judges a layer.

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


def _mscale(factor: float, mscale: float) -> float:
    return 0.1 * mscale * math.log(factor) + 1.0 if factor > 1 else 1.0


def yarn_frequencies(spec: dict) -> torch.Tensor:
    """The rope dims' rotation frequencies, float64 ``[rope / 2]``: base
    ``rope_theta ** (-2j / rope)``; YaRN (the source's
    ``precompute_freqs_cis``) keeps them below the dim that makes
    ``beta_fast`` turns over the original context, divides them by
    ``factor`` above the one that makes ``beta_slow``, and blends them
    linearly between."""
    dim, base = spec["qk_rope_head_dim"], spec["rope_theta"]
    freqs = 1.0 / base ** (torch.arange(0, dim, 2, dtype=torch.float64)
                           / dim)
    scaling = spec.get("rope_scaling")
    if not scaling:
        return freqs
    orig = scaling["original_max_position_embeddings"]

    def dim_of(turns):
        return dim * math.log(orig / (turns * 2 * math.pi)) / (
            2 * math.log(base))

    low = max(math.floor(dim_of(scaling["beta_fast"])), 0)
    high = min(math.ceil(dim_of(scaling["beta_slow"])), dim - 1)
    if low == high:
        high += 0.001
    smooth = 1 - torch.clamp((torch.arange(dim // 2, dtype=torch.float64)
                              - low) / (high - low), 0, 1)
    return freqs / scaling["factor"] * (1 - smooth) + freqs * smooth


def softmax_scale(spec: dict) -> float:
    """``(nope + rope) ** -0.5``, times ``mscale ** 2`` with ``mscale =
    0.1 * mscale_all_dim * ln(factor) + 1`` under YaRN."""
    scale = (spec["qk_nope_head_dim"] + spec["qk_rope_head_dim"]) ** -0.5
    scaling = spec.get("rope_scaling")
    if scaling and scaling.get("mscale_all_dim"):
        m = _mscale(scaling["factor"], scaling["mscale_all_dim"])
        scale = scale * m * m
    return scale


def rotate_pairs(x: torch.Tensor, spec: dict) -> torch.Tensor:
    """``x [seq, heads, rope]`` with each pair (2j, 2j + 1) turned by
    ``position * freq[j]`` as one complex number, positions 0..seq-1."""
    scaling = spec.get("rope_scaling") or {}
    m = 1.0
    if scaling:
        m = (_mscale(scaling["factor"], scaling.get("mscale", 1))
             / _mscale(scaling["factor"], scaling.get("mscale_all_dim", 1)))
    pos = torch.arange(x.shape[0], dtype=torch.float64)
    ang = pos[:, None] * yarn_frequencies(spec)[None, :]
    turn = torch.polar(torch.full_like(ang, m), ang).to(torch.complex64)
    z = torch.view_as_complex(x.float().reshape(*x.shape[:-1], -1, 2)
                              .contiguous())
    return torch.view_as_real(z * turn[:, None, :].to(x.device)).flatten(-2)


def attention(x: torch.Tensor, spec: dict, i: int, weight: Weight,
              batch: int, control: bool = False) -> torch.Tensor:
    """Layer ``i``'s MLA on normed ``x [tokens, hidden]``: the held heads'
    output through the held part of o (a partial sum)."""
    hid, heads = spec["hidden_size"], spec["num_attention_heads"]
    nope, rot = spec["qk_nope_head_dim"], spec["qk_rope_head_dim"]
    dv, eps = spec["v_head_dim"], spec["rms_norm_eps"]
    ql, kvl = spec["q_lora_rank"], spec["kv_lora_rank"]
    q = _product(x, weight(f"{i}.q_a", (ql, hid)), control)
    q = rms_norm(q, weight(f"{i}.q_a_norm", (ql,)), eps)
    q = _product(q, weight(f"{i}.q_b", (heads * (nope + rot), ql)), control)
    kv = _product(x, weight(f"{i}.kv_a", (kvl + rot, hid)), control)
    latent, k_pe = kv[:, :kvl], kv[:, kvl:]
    latent = rms_norm(latent, weight(f"{i}.kv_a_norm", (kvl,)), eps)
    kv = _product(latent, weight(f"{i}.kv_b", (heads * (nope + dv), kvl)),
                  control)
    seq = x.shape[0] // batch
    scale = softmax_scale(spec)
    pos = torch.arange(seq, device=x.device)
    visible = pos[None, :] <= pos[:, None]
    outs = []
    for b in range(batch):
        rows = slice(b * seq, (b + 1) * seq)
        qb = q[rows].view(seq, heads, nope + rot)
        qb = torch.cat([qb[..., :nope], rotate_pairs(qb[..., nope:], spec)],
                       dim=-1)
        kvb = kv[rows].view(seq, heads, nope + dv)
        pe = rotate_pairs(k_pe[rows].view(seq, 1, rot), spec)
        kb = torch.cat([kvb[..., :nope], pe.expand(seq, heads, rot)], dim=-1)
        vb = kvb[..., nope:]
        scores = torch.einsum("qhd,khd->hqk", qb, kb) * scale
        scores = scores.masked_fill(~visible, float("-inf"))
        p = torch.softmax(scores, dim=-1)
        del scores
        outs.append(torch.einsum("hqk,khd->qhd", p, vb).reshape(
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


def is_moe(spec: dict, i: int) -> bool:
    """Layer ``i`` is a MoE layer: past the leading dense ones, at the
    layer frequency."""
    return i >= spec["first_k_dense_replace"] and \
        i % spec["moe_layer_freq"] == 0


def router_scores(x: torch.Tensor, spec: dict, i: int, weight: Weight,
                  control: bool = False
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Layer ``i``'s sigmoid scores ``[tokens, experts]`` over every
    routed expert, and the same plus the correction bias (what the group
    scores and the top-k rank)."""
    n, hid = spec["router_experts"], spec["hidden_size"]
    scores = torch.sigmoid(_product(x, weight(f"{i}.router", (n, hid)),
                                    control))
    return scores, scores + weight(f"{i}.router_bias", (n,)).float()


def group_scores(biased: torch.Tensor, spec: dict) -> torch.Tensor:
    """``[tokens, n_group]``: the sum of each group's two highest score +
    bias (the experts in ``n_group`` equal groups in id order)."""
    t = biased.shape[0]
    return biased.view(t, spec["n_group"], -1).topk(2, dim=-1).values.sum(-1)


def top_choice(biased: torch.Tensor, spec: dict) -> torch.Tensor:
    """Each token's experts ``[tokens, top]``: the top ``topk_group``
    groups kept, the top ``num_experts_per_tok`` of score + bias among
    their experts."""
    t, groups = biased.shape[0], spec["n_group"]
    kept = group_scores(biased, spec).topk(spec["topk_group"], dim=-1).indices
    allowed = torch.zeros((t, groups), dtype=torch.bool,
                          device=biased.device).scatter_(1, kept, True)
    masked = biased.view(t, groups, -1).masked_fill(
        ~allowed[..., None], float("-inf")).view(t, -1)
    return torch.topk(masked, spec["num_experts_per_tok"], dim=-1).indices


def violation(biased: torch.Tensor, choice: torch.Tensor, spec: dict
              ) -> torch.Tensor:
    """How far ``choice [tokens, top]`` is from being a group-limited
    top-k of ``biased [tokens, experts]``, per token, at most 0 where it is
    one: over every set of ``topk_group`` groups that holds the choice's
    groups, the larger of (the best group score left out less the least
    kept) and (the best score + bias of the kept groups' experts not taken
    less the least taken), at its least. Infinite where the choice names
    an expert twice or no such set exists."""
    t, groups = biased.shape[0], spec["n_group"]
    per = biased.shape[1] // groups
    gs = group_scores(biased, spec)[:, None, :]  # [tokens, 1, groups]
    own = torch.zeros((t, 1, groups), dtype=torch.bool, device=biased.device)
    own.scatter_(2, (choice // per)[:, None, :], True)
    sets = torch.combinations(torch.arange(groups, device=biased.device),
                              spec["topk_group"])
    kept = torch.zeros((1, sets.shape[0], groups), dtype=torch.bool,
                       device=biased.device)
    kept[0].scatter_(1, sets, True)  # [1, sets, groups]
    left = biased.scatter(1, choice, float("-inf")).view(t, groups, per)
    best_left = left.amax(-1)[:, None, :]  # the best not taken, per group
    group_gap = gs.masked_fill(kept, float("-inf")).amax(-1) - \
        gs.masked_fill(~kept, float("inf")).amin(-1)
    expert_gap = best_left.masked_fill(~kept, float("-inf")).amax(-1) - \
        torch.gather(biased, 1, choice).amin(-1, keepdim=True)
    holds = (kept | ~own).all(-1)  # the set holds the choice's groups
    gap = torch.maximum(group_gap, expert_gap).masked_fill(~holds, math.inf)
    ids = choice.sort(-1).values
    twice = (ids[:, 1:] == ids[:, :-1]).any(-1)
    return gap.amin(-1).masked_fill(twice, math.inf)


def route(x: torch.Tensor, spec: dict, i: int, weight: Weight,
          control: bool = False, prefer: Optional[torch.Tensor] = None,
          tie: float = 0.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each token's selected experts ``[tokens, top]`` and their weights:
    the group-limited top-k (:func:`top_choice`), weighted by their scores
    over the scores' sum (``norm_topk_prob``) times
    ``routed_scaling_factor``. With ``prefer`` (expert ids ``[tokens,
    top]``), a token takes that choice instead where its
    :func:`violation` is at most ``tie``: a near-tie resolved the other
    way."""
    scores, biased = router_scores(x, spec, i, weight, control)
    sel = top_choice(biased, spec)
    if prefer is not None:
        near = violation(biased, prefer, spec) <= tie
        sel = torch.where(near[:, None], prefer, sel)
    w = torch.gather(scores, 1, sel)
    if spec["norm_topk_prob"]:
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
    """Layer ``i``'s shared expert on normed ``x``: a SwiGLU of
    ``n_shared_experts`` experts' width on every token."""
    hid = spec["hidden_size"]
    width = spec["moe_intermediate_size"] * spec["n_shared_experts"]
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
        h = h + attention(x, spec, i, weight, batch, control)
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
