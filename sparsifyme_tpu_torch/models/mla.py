"""Multi-head latent attention (MLA), DeepSeek-V3's attention block, as one
card's share of the heads, on 2:4-pruned weights and feature-major
activations ``[features, tokens]`` like the rest of
:mod:`.moe_transformer`.

Per token (published widths: hidden 7168, q latent ``q_lora_rank`` 1536,
kv latent ``kv_lora_rank`` 512, per head ``qk_nope_head_dim`` 128 and
``qk_rope_head_dim`` 64 of q and k, ``v_head_dim`` 128)::

    c_q           = RMSNorm(W_qa x)           # the q latent
    [q_nope|q_pe] = W_qb c_q                  # per head
    [c_kv, k_pe]  = W_kva x                   # the kv latent, and one rope
                                              # key that every head shares
    [k_nope | v]  = W_kvb RMSNorm(c_kv)       # per head
    q = [q_nope, rope(q_pe)],  k = [k_nope, rope(k_pe)]
    out = W_o concat(softmax(q k^T * scale, causal) v)

This is the prefill's decompressed form: k and v per head, q and k 192
wide and v 128 through ``scaled_dot_product_attention``, as
:func:`.moe_transformer.full_attention` runs MiMo's full layers. Decode's
absorbed form, attending over the cached latent, is not here. The output
projection sums over the heads this card holds: the partial sum that
tensor parallelism would all-reduce; q_a and kv_a are whole on every
card.

RoPE turns the interleaved pairs ``(2j, 2j + 1)`` of the rope dims by
position x ``inv_freq[j]``, as the source's inference code does with
``view_as_complex`` (:func:`rope_pairs`; not the rotate-half layout of
:func:`.moe_transformer.rope`), in float32, rounded once. ``inv_freq`` is
YaRN's (:func:`yarn_inv_freq`): the base frequencies below
``beta_fast`` rotations over ``original_max_position_embeddings``
positions, those divided by ``factor`` above ``beta_slow``, a linear ramp
between. The softmax scale is ``(nope + rope) ** -0.5`` times YaRN's
mscale squared (:func:`softmax_scale`: 0.1 ln 40 + 1 at DeepSeek-V3's
factor 40, so 0.13523).

The five products are 2:4 weights (:func:`.moe_transformer.sparse_weight`;
kv_a's 576 rows are not whole 128-row tiles, so K3 runs it on its
``mma_sp`` tile), the latent norms' weights dense. :func:`mla_attention`
records ``sparsifyme.mla`` with the phases ``q_latent`` (the input norm,
the q_a and kv_a products, the q latent's norm), ``kv_latent`` (the kv
latent's norm, the q_b and kv_b products), ``rope`` (heads split, RoPE,
k assembled), ``core`` and ``out`` (the o product and the residual add),
and enters ``products()`` around its three groups of 2:4 products (q_a
with kv_a; q_b with kv_b; o).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
from typing import Callable, Optional, Tuple

import torch

from ..utils import trace
from . import moe_transformer as mt

# the block's 2:4 weights, and the parts whose shapes are MLA's own
PRODUCTS = ("q_a", "q_b", "kv_a", "kv_b", "o")
SHAPES = PRODUCTS + ("q_a_norm", "kv_a_norm")


@dataclasses.dataclass
class Mla:
    norm: torch.Tensor  # [hidden]
    q_a: mt.Linear  # [q_lora_rank, hidden]
    q_a_norm: torch.Tensor  # [q_lora_rank]
    q_b: mt.Linear  # [heads * (nope + rope), q_lora_rank]
    kv_a: mt.Linear  # [kv_lora_rank + rope, hidden]: c_kv rows, then k_pe
    kv_a_norm: torch.Tensor  # [kv_lora_rank]
    kv_b: mt.Linear  # [heads * (nope + v), kv_lora_rank]: per head k_nope, v
    o: mt.Linear  # [hidden, heads * v]
    heads: int

    PRODUCTS = PRODUCTS  # its 2:4 weights, as moe_transformer's blocks


def weight_shape(config, part: str) -> Tuple[int, ...]:
    """The shape of part ``part`` (one of :data:`SHAPES`) of a layer."""
    c, hid, heads = config, config.hidden_size, config.num_attention_heads
    nope, rot = c.qk_nope_head_dim, c.qk_rope_head_dim
    return {"q_a": (c.q_lora_rank, hid),
            "q_a_norm": (c.q_lora_rank,),
            "q_b": (heads * (nope + rot), c.q_lora_rank),
            "kv_a": (c.kv_lora_rank + rot, hid),
            "kv_a_norm": (c.kv_lora_rank,),
            "kv_b": (heads * (nope + c.v_head_dim), c.kv_lora_rank),
            "o": (hid, heads * c.v_head_dim)}[part]


def init_mla(config, w: Callable[[str], torch.Tensor], layer: int) -> Mla:
    """Layer ``layer``'s block from ``w(name)``, a dense bf16 tensor of
    :func:`weight_shape`'s shape (names ``<layer>.<part>``): the products
    pruned, compressed and packed one at a time, the norms as given."""
    sparse = {n: mt.sparse_weight(w(f"{layer}.{n}")) for n in PRODUCTS}
    return Mla(norm=w(f"{layer}.attn_norm"),
               q_a_norm=w(f"{layer}.q_a_norm"),
               kv_a_norm=w(f"{layer}.kv_a_norm"),
               heads=config.num_attention_heads, **sparse)


def _yarn_mscale(factor: float, mscale: float) -> float:
    return 0.1 * mscale * math.log(factor) + 1.0 if factor > 1 else 1.0


def yarn_inv_freq(dim: int, theta: float, scaling: Optional[dict]
                  ) -> torch.Tensor:
    """The ``dim // 2`` rotation frequencies of a rope head ``dim`` wide,
    float64: ``theta ** (-2j / dim)``, with YaRN's ``rope_scaling``
    (``factor``, ``original_max_position_embeddings``, ``beta_fast``,
    ``beta_slow``) those past the correction range divided by ``factor``
    and a linear ramp across it."""
    freq = theta ** (-torch.arange(0, dim, 2, dtype=torch.float64) / dim)
    if not scaling:
        return freq
    if scaling.get("type", "yarn") != "yarn":
        raise ValueError(f"rope_scaling {scaling!r} is not YaRN's")
    orig = scaling["original_max_position_embeddings"]

    def turns(rotations):  # the dim at which a frequency makes them
        return dim * math.log(orig / (rotations * 2 * math.pi)) / (
            2 * math.log(theta))

    low = max(math.floor(turns(scaling["beta_fast"])), 0)
    high = min(math.ceil(turns(scaling["beta_slow"])), dim - 1)
    if low == high:
        high += 0.001
    ramp = ((torch.arange(dim // 2, dtype=torch.float64) - low)
            / (high - low)).clamp(0, 1)
    return freq / scaling["factor"] * ramp + freq * (1 - ramp)


def softmax_scale(config) -> float:
    """``(nope + rope) ** -0.5``, times YaRN's mscale squared where the
    configuration's ``rope_scaling`` gives ``mscale_all_dim``."""
    scale = (config.qk_nope_head_dim + config.qk_rope_head_dim) ** -0.5
    scaling = dict(config.rope_scaling or ())
    if scaling.get("mscale_all_dim"):
        m = _yarn_mscale(scaling["factor"], scaling["mscale_all_dim"])
        scale *= m * m
    return scale


@functools.lru_cache(maxsize=16)
def _yarn_table(seq: int, dim: int, theta: float, scaling: tuple,
                device: str):
    """cos and sin ``[seq, dim // 2]`` float32 of positions 0..seq-1, each
    times YaRN's ratio ``mscale(factor, mscale) / mscale(factor,
    mscale_all_dim)`` (1 where both are 1, as in DeepSeek-V3)."""
    s = dict(scaling or ())
    ang = torch.arange(seq, dtype=torch.float64)[:, None] * yarn_inv_freq(
        dim, theta, s)[None]
    m = 1.0
    if s:
        m = (_yarn_mscale(s["factor"], s.get("mscale", 1))
             / _yarn_mscale(s["factor"], s.get("mscale_all_dim", 1)))
    return ((ang.cos() * m).float().to(device),
            (ang.sin() * m).float().to(device))


def rope_pairs(y: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """Turn the interleaved pairs ``(2j, 2j + 1)`` of ``y [..., seq, 2r]``
    in place by ``cos`` / ``sin [seq, r]`` (computed in float32, rounded
    once); returns ``y``."""
    r = y.float().unflatten(-1, (-1, 2))
    a, b = r[..., 0], r[..., 1]
    y.copy_(torch.stack((a * cos - b * sin, b * cos + a * sin),
                        dim=-1).flatten(-2))
    return y


def mla_attention(p: Mla, h: torch.Tensor, config, batch: int,
                  products: mt.Products = contextlib.nullcontext
                  ) -> torch.Tensor:
    """``h + MLA(RMSNorm(h))`` for ``batch`` sequences of equal length,
    ``h [hidden, tokens]`` float32: the heads this card holds, the output
    projection's partial sum. ``products()`` is entered around the 2:4
    products (q_a, kv_a; q_b, kv_b; o)."""
    call = trace.begin("sparsifyme.mla", "q_latent")
    try:
        eps = config.layernorm_epsilon
        nope, rot = config.qk_nope_head_dim, config.qk_rope_head_dim
        lat, t = config.kv_lora_rank, h.shape[1]
        seq = t // batch
        x = mt.rms_norm(h, p.norm, eps)
        with products():
            cq, ckv = mt.linear(p.q_a, x), mt.linear(p.kv_a, x)
        cq = mt.rms_norm(cq, p.q_a_norm, eps)
        trace.mark("kv_latent")
        ckv_n = mt.rms_norm(ckv[:lat], p.kv_a_norm, eps)
        with products():
            q, kv = mt.linear(p.q_b, cq), mt.linear(p.kv_b, ckv_n)
        trace.mark("rope")
        cos, sin = _yarn_table(seq, rot, float(config.rope_theta),
                               config.rope_scaling, str(h.device))
        q = mt.split_heads(q, p.heads, batch)  # [B, heads, S, nope + rope]
        rope_pairs(q[..., nope:], cos, sin)
        kv = kv.view(p.heads, -1, batch, seq).permute(2, 0, 3, 1)
        k = torch.empty_like(q)
        k[..., :nope] = kv[..., :nope]
        k_pe = ckv[lat:].view(rot, batch, seq).permute(1, 2, 0).contiguous()
        k[..., nope:] = rope_pairs(k_pe, cos, sin)[:, None]
        v = kv[..., nope:].contiguous()
        trace.mark("core")
        o = mt.full_attention(q, k, v, softmax_scale(config))
        trace.mark("out")
        o = o.permute(1, 3, 0, 2).reshape(-1, t)
        with products():
            o = mt.linear(p.o, o)
        return h + o
    finally:
        if call:
            trace.end(call)
