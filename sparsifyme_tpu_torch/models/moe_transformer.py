"""A mixture-of-experts transformer with 2:4-pruned linear weights, as one
card's share of a layer that several cards divide: MiMo-V2-Flash's block
(hybrid window / full GQA attention), DeepSeek-V3's (multi-head latent
attention, :mod:`.mla`; a group-limited router, a routed scale and a
shared expert) and Kimi Linear's (Kimi Delta Attention, :mod:`.kda`, in
the layers that ``linear_attn_config`` names, NoPE MLA without a q latent
in the others; the router and shared expert of DeepSeek-V3's).

Every linear weight of the blocks (q, k, v, o, the dense FFN, each
expert's gate, up and down) is pruned 2:4 along its input axis and
compressed by K2 (:func:`~..ops.sparse24.prune_compress_24`), packed for
K3's ``wgmma_sp`` route where its row count allows (:func:`~..ops.sparse24.
pack_wg`, M % 128 == 0) and run by :func:`~..ops.sparse24.spmm_24`. The
router, the embedding and the head stay dense bf16, as pruning practice
leaves them. A weight given as a dense tensor runs through ``torch.matmul``
instead (:func:`densify`: the dense baseline).

Activations are feature-major ``[features, tokens]``, so that one layer's
product is the next one's B operand as K3 takes it (``spmm_24(W, x)`` is
``W @ x``); the residual stream is float32, every product's operands bf16.

One block (pre-norm, RMSNorm without bias)::

    h = x + Attn(RMSNorm(x));  y = h + FFN(RMSNorm(h))

* Attention: GQA with q/k head size ``head_dim`` and v head size
  ``v_head_dim``; rotate-half RoPE on the first ``int(partial_rotary_factor
  * head_dim)`` dims of q and k (the rest pass through); softmax scale
  ``head_dim ** -0.5``, causal; a window layer lets query i see keys
  ``i - window + 1 .. i`` and adds a per-head sink logit to the softmax's
  denominator (a key of value zero); V is scaled by
  ``attention_value_scale``. The output projection sums over the heads this
  card holds: the partial sum that tensor parallelism would all-reduce.
* FFN: SwiGLU ``W2(silu(W1 x) * W3 x)``, gate and up fused into one 2:4
  weight. A MoE layer routes every token over all ``n_routed_experts``:
  sigmoid scores, the top ``num_experts_per_tok`` of score + correction
  bias, weights the selected scores over their sum, and adds the share of
  the experts this card holds (``held_experts``); the other experts' share
  is another card's. DeepSeek-V3's router first keeps each token's
  ``topk_group`` of ``n_group`` expert groups (a group's score: the sum
  of its two highest score + bias) and chooses only among their experts,
  multiplies the weights by ``routed_scaling_factor``, and the layer adds
  a shared expert (a SwiGLU ``n_shared_experts`` experts wide) on every
  token; MiMo's values (1, 1, None, None) leave these out.

The MoE layer is three public steps that :func:`forward` composes, four
with a shared expert:
:func:`moe_route` (router, selection, tokens grouped by held expert, each
group padded to a multiple of ``PAD_ROWS`` so that K3's ``wgmma_sp`` route
takes every call), where the layer has one :func:`moe_shared` (the shared
expert's two 2:4 products on every token, feature-major, added to the
residual stream), :func:`moe_experts` (two 2:4 products an expert) and
:func:`moe_combine` (each token's rows weighted, summed and added to the
residual stream). The expert layer gathers token-major ``[tokens,
hidden]`` rows, each a contiguous run, and turns each expert's rows
feature-major for its products: on the H100, gathering and scattering
columns of the feature-major tensors instead (``index_select`` /
``index_add_`` on dim 1, a strided access a column) took 96 ms of a 323
ms pass, against 44 ms for these transposes, the cat and a scatter of
rows. On a card the combine is one hand-written kernel
(:mod:`~..ops.kernels.moe_kernel`) that reads each token's held rows
through the dispatch's slot map and writes ``h + sum w * y`` in one pass
over h; on the CPU its plain version scatters the weighted rows into an
f32 accumulator (``index_add_``) and adds its transpose. Every RMSNorm is
one launch of the norm kernel on a card (:mod:`~..ops.kernels.
norm_kernel`: h read once, bf16 written feature-major, token-major for
the expert layer's rows, or both; counter ``norm.kernel``), four float32
PyTorch ops on the CPU. They record one
program span ``sparsifyme.moe`` (phases ``router``, ``select``,
``dispatch``, ``shared``, ``experts``, ``combine``) and the counters
``moe.rows`` / ``moe.pad_rows`` (and ``moe.combine_kernel``, one a
kernel launch; ``moe.shared_rows``, the tokens through a shared expert;
``moe.group_tokens``, the tokens whose kept groups hold a held expert,
read in the group sizes' copy); :func:`attention` records
``sparsifyme.attention`` (``proj``, ``rope``, ``core``, ``out``),
:func:`.mla.mla_attention` ``sparsifyme.mla`` and :func:`.kda.kda_attention`
``sparsifyme.kda``.
:func:`attention`, :func:`.mla.mla_attention`, :func:`.kda.kda_attention`
and :func:`dense_ffn` enter an optional ``products()`` context around their
2:4 products, so a caller can time them apart (a profiler's range).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import (Callable, ContextManager, List, Optional, Tuple,
                    Union)

import torch
import torch.nn.functional as F

from .. import _build
from ..containers import Sparse24
from ..ops.kernels import moe_kernel, norm_kernel
from ..ops.sparse24 import (decompress_24, pack_refusal, pack_wg,
                            prune_compress_24, spmm_24)
from ..utils import trace

BF16 = torch.bfloat16
PAD_ROWS = 64  # a group's rows: a multiple of the wgmma_sp route's n tile
Linear = Union[Sparse24, torch.Tensor]
# weight(name, shape) -> a dense bf16 tensor on the device the model runs on
WeightFn = Callable[[str, Tuple[int, ...]], torch.Tensor]
# entered around a block's 2:4 products (a profiler's range, say)
Products = Callable[[], ContextManager]


# the keys of linear_attn_config that a Kimi Delta Attention config gives
KDA_FIELDS = ("num_heads", "head_dim", "short_conv_kernel_size",
              "kda_layers", "full_attn_layers")
# the fields of MiMo-V2-Flash's GQA attention, which a config without
# q_lora_rank has to give
GQA_FIELDS = ("hybrid_layer_pattern", "head_dim", "swa_head_dim",
              "swa_v_head_dim", "swa_num_attention_heads",
              "swa_num_key_value_heads", "sliding_window",
              "add_swa_attention_sink_bias", "add_full_attention_sink_bias",
              "partial_rotary_factor", "swa_rope_theta",
              "attention_value_scale")


@dataclasses.dataclass(frozen=True)
class MoeTransformerConfig:
    """Widths and conventions of the model, and what this card holds:
    ``num_attention_heads`` / ``num_key_value_heads`` (and the ``swa_``
    pair of window layers) count the heads held here, ``held_experts``
    the experts (of ``n_routed_experts`` the router scores). The GQA and
    window fields are MiMo-V2-Flash's; a model with ``q_lora_rank`` or
    ``kv_lora_rank`` set runs multi-head latent attention (:mod:`.mla`)
    instead, and one with ``linear_attn_config`` Kimi Delta Attention
    (:mod:`.kda`) in the layers it lists (:meth:`attention_kind_of`).
    ``n_group`` 1, ``topk_group`` 1, ``routed_scaling_factor``
    None and ``n_shared_experts`` None select the router and expert layer
    without DeepSeek-V3's group limit, scale and shared expert."""

    hidden_size: int
    intermediate_size: int
    moe_intermediate_size: int
    vocab_size: int
    # per layer: 1 a MoE layer, 0 a dense FFN
    moe_layer_freq: Tuple[int, ...]
    num_attention_heads: int
    num_key_value_heads: int
    v_head_dim: int
    n_routed_experts: int
    held_experts: Tuple[int, ...]
    num_experts_per_tok: int
    norm_topk_prob: bool
    rope_theta: float
    layernorm_epsilon: float
    # GQA (every field required where q_lora_rank is None): per layer 1 a
    # window (SWA) layer, 0 a full-attention layer
    hybrid_layer_pattern: Optional[Tuple[int, ...]] = None
    head_dim: Optional[int] = None
    swa_head_dim: Optional[int] = None
    swa_v_head_dim: Optional[int] = None
    swa_num_attention_heads: Optional[int] = None
    swa_num_key_value_heads: Optional[int] = None
    sliding_window: Optional[int] = None
    add_swa_attention_sink_bias: Optional[bool] = None
    add_full_attention_sink_bias: Optional[bool] = None
    partial_rotary_factor: Optional[float] = None
    swa_rope_theta: Optional[float] = None
    attention_value_scale: Optional[float] = None
    # the router's group limit: the experts fall in n_group equal groups
    # and a token chooses only in the topk_group of highest group score
    n_group: int = 1
    topk_group: int = 1
    routed_scaling_factor: Optional[float] = None  # times the weights
    # a shared expert of n_shared_experts experts' width, on every token
    n_shared_experts: Optional[int] = None
    # multi-head latent attention where q_lora_rank is set (models/mla.py;
    # the three widths then required)
    q_lora_rank: Optional[int] = None
    kv_lora_rank: Optional[int] = None
    qk_nope_head_dim: Optional[int] = None
    qk_rope_head_dim: Optional[int] = None
    # YaRN's keys of the source's ``rope_scaling``, as (key, value) pairs
    rope_scaling: Optional[Tuple[Tuple[str, Union[float, str]], ...]] = None
    # MLA with nothing rotated (Kimi Linear's)
    mla_use_nope: bool = False
    # Kimi Delta Attention in the layers of ``kda_layers`` (1-indexed), as
    # (key, value) pairs of the source's ``linear_attn_config``:
    # ``num_heads``, ``head_dim``, ``short_conv_kernel_size``,
    # ``kda_layers``, ``full_attn_layers``
    linear_attn_config: Optional[Tuple[Tuple[str, object], ...]] = None

    def __post_init__(self):
        mla_kind = self.q_lora_rank is not None or \
            self.kv_lora_rank is not None
        need = ("kv_lora_rank", "qk_nope_head_dim", "qk_rope_head_dim") \
            if mla_kind else GQA_FIELDS
        missing = [n for n in need if getattr(self, n) is None]
        if missing:
            raise ValueError(
                f"{'multi-head latent' if mla_kind else 'GQA'} attention "
                f"needs {', '.join(missing)}")
        if self.linear_attn_config is not None:
            lin = dict(self.linear_attn_config)
            missing = [n for n in KDA_FIELDS if n not in lin]
            if missing:
                raise ValueError("Kimi Delta Attention needs "
                                 f"{', '.join(missing)}")
            every = sorted(lin["kda_layers"] + lin["full_attn_layers"])
            if every != list(range(1, len(self.moe_layer_freq) + 1)):
                raise ValueError("kda_layers and full_attn_layers do not "
                                 "name every layer once")
        if not mla_kind and \
                len(self.hybrid_layer_pattern) != len(self.moe_layer_freq):
            raise ValueError("hybrid_layer_pattern and moe_layer_freq give "
                             "different numbers of layers")

    @property
    def num_hidden_layers(self) -> int:
        return len(self.moe_layer_freq)

    @classmethod
    def from_dict(cls, keys: dict, **over) -> "MoeTransformerConfig":
        """From a dict with the source's ``config.json`` keys (others are
        ignored), lists as tuples and dicts as sorted (key, value) pairs
        (a list among their values a tuple); ``over`` sets fields
        besides."""
        def frozen(v):
            return tuple(v) if isinstance(v, list) else v

        names = {f.name for f in dataclasses.fields(cls)}
        got = {k: tuple(sorted((a, frozen(b)) for a, b in v.items()))
               if isinstance(v, dict) else frozen(v)
               for k, v in keys.items() if k in names}
        got.update(over)
        return cls(**got)

    def attention_kind_of(self, layer: int) -> str:
        """Layer ``layer``'s (0-indexed) attention: ``"kda"`` where
        ``linear_attn_config`` lists it among ``kda_layers`` (1-indexed),
        else ``"mla"`` where the config has latent widths, else
        ``"gqa"``."""
        if self.linear_attn_config is not None and \
                layer + 1 in dict(self.linear_attn_config)["kda_layers"]:
            return "kda"
        if self.q_lora_rank is not None or self.kv_lora_rank is not None:
            return "mla"
        return "gqa"

    def attention_shape(self, layer: int):
        """``(heads, kv heads, qk dim, v dim, window, sink, rope theta)``
        of GQA layer ``layer`` (window 0: full attention)."""
        if self.hybrid_layer_pattern[layer]:
            return (self.swa_num_attention_heads,
                    self.swa_num_key_value_heads, self.swa_head_dim,
                    self.swa_v_head_dim, self.sliding_window,
                    self.add_swa_attention_sink_bias, self.swa_rope_theta)
        return (self.num_attention_heads, self.num_key_value_heads,
                self.head_dim, self.v_head_dim, 0,
                self.add_full_attention_sink_bias, self.rope_theta)


@dataclasses.dataclass
class Attention:
    norm: torch.Tensor  # [hidden]
    q: Linear  # [heads * qk_dim, hidden]
    k: Linear  # [kv_heads * qk_dim, hidden]
    v: Linear  # [kv_heads * v_dim, hidden]
    o: Linear  # [hidden, heads * v_dim]
    sinks: Optional[torch.Tensor]  # [heads] float32, or None
    heads: int
    kv_heads: int
    window: int  # 0: full attention
    rope_theta: float

    PRODUCTS = ("q", "k", "v", "o")  # its 2:4 weights


@dataclasses.dataclass
class DenseFfn:
    norm: torch.Tensor
    gate_up: Linear  # [2 * intermediate, hidden]: gate rows, then up rows
    down: Linear  # [hidden, intermediate]


@dataclasses.dataclass
class Moe:
    norm: torch.Tensor
    router: torch.Tensor  # [n_routed_experts, hidden] bf16, dense
    bias: torch.Tensor  # [n_routed_experts] float32 correction bias
    experts: List[Tuple[Linear, Linear]]  # per held expert: gate_up, down
    local: torch.Tensor  # [n_routed_experts] int64: held index, or -1
    shared: Optional[Tuple[Linear, Linear]] = None  # gate_up, down


@dataclasses.dataclass
class Params:
    embed: torch.Tensor  # [vocab, hidden] bf16
    # each layer's attention block (an Attention, or .mla.Mla) and FFN
    layers: List[Tuple[object, Union[DenseFfn, Moe]]]
    norm: torch.Tensor
    head: torch.Tensor  # [vocab, hidden] bf16


@dataclasses.dataclass
class Dispatch:
    """Tokens grouped by held expert: ``index[r]`` is row r's token and
    ``weight[r]`` its routing weight (0 on the padding rows, which repeat
    token 0); held expert e's rows are ``bounds[e]``, ``rows[e]`` of them
    real. ``selected [tokens, top]`` holds every token's chosen experts
    (of all). ``slot [tokens, top]`` int32 is the inverse map: the row of
    each (token, choice) whose expert this card holds, -1 where another
    card holds it; no padding row is named. ``call`` is the open
    ``sparsifyme.moe`` record, which :func:`moe_combine` closes.
    ``normed`` is the layer's normed input feature-major ``[hidden,
    tokens]`` bf16 where the layer has a shared expert, until
    :func:`moe_shared` takes it."""

    index: torch.Tensor
    weight: torch.Tensor
    bounds: List[Tuple[int, int]]
    rows: List[int]
    selected: torch.Tensor
    slot: torch.Tensor
    call: Optional[int] = None
    normed: Optional[torch.Tensor] = None


# --- set-up ----------------------------------------------------------------

def sparse_weight(w: torch.Tensor) -> Sparse24:
    """A dense weight ``[M, K]`` pruned 2:4 along K and compressed (K2's
    fused route), packed for K3's ``wgmma_sp`` route where
    :func:`~..ops.sparse24.pack_refusal` allows."""
    s = prune_compress_24(w)
    return s if pack_refusal(s) else pack_wg(s)


def weight_shape(config: MoeTransformerConfig, name: str
                 ) -> Tuple[int, ...]:
    """The shape of the weight called ``name`` (``embed``, ``head``,
    ``norm`` or ``<layer>.<part>``): ``[out, in]`` for a product."""
    c, hid = config, config.hidden_size
    if name in ("embed", "head"):
        return (c.vocab_size, hid)
    if name == "norm":
        return (hid,)
    layer, part = name.split(".", 1)
    if part.startswith("e") or part.startswith("shared."):
        kind, proj = part.split(".")
        part = ("shared_" if kind == "shared" else "expert_") + proj
    attn = c.attention_kind_of(int(layer))
    if attn == "kda":
        from . import kda  # it imports this module
        if part in kda.SHAPES:
            return kda.weight_shape(c, part)
    if attn == "mla":
        from . import mla  # it imports this module
        if part in mla.SHAPES:
            return mla.weight_shape(c, part)
    shared = c.moe_intermediate_size * (c.n_shared_experts or 0)
    ffn = {"attn_norm": (hid,), "ffn_norm": (hid,),
           "gate": (c.intermediate_size, hid),
           "up": (c.intermediate_size, hid),
           "down": (hid, c.intermediate_size),
           "router": (c.n_routed_experts, hid),
           "router_bias": (c.n_routed_experts,),
           "expert_gate": (c.moe_intermediate_size, hid),
           "expert_up": (c.moe_intermediate_size, hid),
           "expert_down": (hid, c.moe_intermediate_size),
           "shared_gate": (shared, hid), "shared_up": (shared, hid),
           "shared_down": (hid, shared)}
    if part in ffn:
        return ffn[part]
    heads, kv, dqk, dv, _, _, _ = c.attention_shape(int(layer))
    return {"q": (heads * dqk, hid), "k": (kv * dqk, hid),
            "v": (kv * dv, hid), "o": (hid, heads * dv),
            "sinks": (heads,)}[part]


def init_params(config: MoeTransformerConfig, weight: WeightFn) -> Params:
    """The model's parameters from ``weight(name, shape)``, one dense bf16
    tensor at a time (names ``embed``, ``head``, ``norm`` and, per layer
    ``i``, ``i.attn_norm``, ``i.q``, ``i.k``, ``i.v``, ``i.o``, ``i.sinks``
    (window layers) or MLA's (:func:`.mla.init_mla`), ``i.ffn_norm``, then
    ``i.gate`` / ``i.up`` / ``i.down`` or ``i.router``, ``i.router_bias``,
    ``i.e<expert>.gate`` / ``.up`` / ``.down`` for each held expert and
    ``i.shared.gate`` / ``.up`` / ``.down`` where the layer has a shared
    expert; a KDA layer's names are :func:`.kda.init_kda`'s; shapes by
    :func:`weight_shape`): each product's weight pruned,
    compressed and packed (:func:`sparse_weight`), gate and up stacked
    first; norms, sinks, the router and its bias, the embedding and the
    head as given (bias and sinks float32). Each dense weight is dropped
    once prepared."""
    def w(name):
        return weight(name, weight_shape(config, name))

    def fused(gate, up):
        return sparse_weight(torch.cat([w(gate), w(up)]))

    layers = []
    for i in range(config.num_hidden_layers):
        init_attn, _ = attention_kind(config, i)
        attn = init_attn(config, w, i)
        if config.moe_layer_freq[i]:
            router = w(f"{i}.router")
            local = torch.full((config.n_routed_experts,), -1,
                               dtype=torch.int64, device=router.device)
            local[list(config.held_experts)] = torch.arange(
                len(config.held_experts), device=router.device)
            ffn = Moe(norm=w(f"{i}.ffn_norm"), router=router,
                      bias=w(f"{i}.router_bias").float(),
                      experts=[(fused(f"{i}.e{e}.gate", f"{i}.e{e}.up"),
                                sparse_weight(w(f"{i}.e{e}.down")))
                               for e in config.held_experts],
                      local=local)
            if config.n_shared_experts:
                ffn.shared = (fused(f"{i}.shared.gate", f"{i}.shared.up"),
                              sparse_weight(w(f"{i}.shared.down")))
        else:
            ffn = DenseFfn(norm=w(f"{i}.ffn_norm"),
                           gate_up=fused(f"{i}.gate", f"{i}.up"),
                           down=sparse_weight(w(f"{i}.down")))
        layers.append((attn, ffn))
    return Params(embed=w("embed"), layers=layers, norm=w("norm"),
                  head=w("head"))


def init_attention(config: MoeTransformerConfig,
                   w: Callable[[str], torch.Tensor], layer: int) -> Attention:
    """Layer ``layer``'s GQA block from ``w(name)`` (the dense weight of
    that name and its shape): q, k, v and o through :func:`sparse_weight`,
    the sinks float32 where the layer has them."""
    i = layer
    heads, kv, _, _, window, sink, theta = config.attention_shape(i)
    return Attention(
        norm=w(f"{i}.attn_norm"), q=sparse_weight(w(f"{i}.q")),
        k=sparse_weight(w(f"{i}.k")), v=sparse_weight(w(f"{i}.v")),
        o=sparse_weight(w(f"{i}.o")),
        sinks=w(f"{i}.sinks").float() if sink else None,
        heads=heads, kv_heads=kv, window=window, rope_theta=theta)


def attention_kind(config: MoeTransformerConfig, layer: int):
    """``(init, step)`` of layer ``layer``'s attention block
    (:meth:`MoeTransformerConfig.attention_kind_of`): MiMo's GQA
    (:func:`init_attention`, :func:`attention`), multi-head latent
    attention (:func:`.mla.init_mla`, :func:`.mla.mla_attention`) or Kimi
    Delta Attention (:func:`.kda.init_kda`, :func:`.kda.kda_attention`).
    Each block's dataclass names its 2:4 weights in ``PRODUCTS``."""
    kind = config.attention_kind_of(layer)
    if kind == "gqa":
        return init_attention, attention
    if kind == "mla":
        from . import mla  # it imports this module
        return mla.init_mla, mla.mla_attention
    from . import kda  # it imports this module
    return kda.init_kda, kda.kda_attention


def densify(params: Params) -> Params:
    """``params`` with every 2:4 weight expanded to its dense bf16 matrix
    (zeros kept): the same model through ``torch.matmul``."""
    def d(x):
        return decompress_24(x) if isinstance(x, Sparse24) else x

    layers = []
    for attn, ffn in params.layers:
        attn = dataclasses.replace(attn, **{n: d(getattr(attn, n))
                                            for n in attn.PRODUCTS})
        if isinstance(ffn, Moe):
            shared = ffn.shared and tuple(d(x) for x in ffn.shared)
            ffn = dataclasses.replace(ffn, experts=[
                (d(gu), d(dn)) for gu, dn in ffn.experts], shared=shared)
        else:
            ffn = dataclasses.replace(ffn, gate_up=d(ffn.gate_up),
                                      down=d(ffn.down))
        layers.append((attn, ffn))
    return dataclasses.replace(params, layers=layers)


# --- pieces ----------------------------------------------------------------

def linear(w: Linear, x: torch.Tensor) -> torch.Tensor:
    """``w @ x`` for feature-major ``x [in, tokens]`` bf16: ``spmm_24`` on a
    2:4 weight, ``torch.matmul`` on a dense one; bf16 out."""
    if isinstance(w, Sparse24):
        return spmm_24(w, x, out_dtype=BF16)
    return torch.matmul(w, x)


def product_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` of bf16 operands with float32 accumulation and a float32
    result (batched over leading dims): cuBLAS's ``out_dtype`` on a card,
    the float32 product of the same values on the CPU."""
    if a.is_cuda:
        if a.dim() == 2:
            return torch.mm(a, b, out_dtype=torch.float32)
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.matmul(a.float(), b.float())


def rms_norm(h: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm of feature-major ``h [hidden, tokens]`` (float32, or a bf16
    latent) by weight ``w [hidden]``, bf16 ``[hidden, tokens]`` out."""
    return rms_norm_layouts(h, w, eps, True, False)[0]


def rms_norm_layouts(h: torch.Tensor, w: torch.Tensor, eps: float,
                     feature: bool, token: bool
                     ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """:func:`rms_norm` in the layouts its reader wants: ``(x, x_t)``, ``x
    [hidden, tokens]`` where ``feature``, ``x_t = x.T`` contiguous
    ``[tokens, hidden]`` where ``token``, else None. On a card one launch of
    the norm kernel writes both from one read of h (counted by
    ``norm.kernel``); on the CPU the plain version runs on h in float32 and
    ``x_t`` is its transpose."""
    if _build.use_kernel(h):
        x = torch.empty(h.shape, dtype=BF16, device=h.device) \
            if feature else None
        x_t = torch.empty((h.shape[1], h.shape[0]), dtype=BF16,
                          device=h.device) if token else None
        norm_kernel.rms_norm_cuda(h, w, eps, x, x_t)
        return x, x_t
    x = norm_kernel.rms_norm_plain(h.float(), w, eps)
    return (x if feature else None), (x.T.contiguous() if token else None)


@functools.lru_cache(maxsize=16)
def _rope_table(seq: int, rot: int, theta: float, device: str):
    inv = theta ** (-torch.arange(0, rot, 2, dtype=torch.float64) / rot)
    ang = torch.arange(seq, dtype=torch.float64)[:, None] * inv[None]
    return (ang.cos().float().to(device), ang.sin().float().to(device))


def split_heads(x: torch.Tensor, heads: int, batch: int) -> torch.Tensor:
    """Feature-major ``x [heads * dim, batch * seq]`` as a contiguous
    ``[batch, heads, seq, dim]`` of its dtype."""
    dim, seq = x.shape[0] // heads, x.shape[1] // batch
    return x.view(heads, dim, batch, seq).permute(2, 0, 3, 1).contiguous()


def rope(y: torch.Tensor, theta: float, rot: int) -> torch.Tensor:
    """Rotate-half RoPE in place on the first ``rot`` dims of ``y [batch,
    heads, seq, dim]`` (computed in float32, rounded once), positions
    0..seq-1 in each sequence; returns ``y``."""
    if rot:
        cos, sin = _rope_table(y.shape[2], rot, float(theta), str(y.device))
        half = rot // 2
        r = y[..., :rot].float()
        x1, x2 = r[..., :half], r[..., half:]
        y[..., :half] = x1 * cos - x2 * sin
        y[..., half:rot] = x2 * cos + x1 * sin
    return y


def full_attention(q, k, v, scale: float) -> torch.Tensor:
    """Causal GQA: ``q [B, heads, S, d]``, ``k [B, kv, S, d]``, ``v [B, kv,
    S, dv]`` bf16 to ``[B, heads, S, dv]`` bf16, softmax scale ``scale``."""
    b, heads, s, d = q.shape
    g = heads // k.shape[1]
    k = k[:, :, None].expand(-1, -1, g, -1, -1).reshape(b, heads, s, d)
    v = v[:, :, None].expand(-1, -1, g, -1, -1).reshape(
        b, heads, s, v.shape[-1])
    return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                          scale=scale)


@functools.lru_cache(maxsize=16)
def _band(window: int, group: int, device: str) -> torch.Tensor:
    """Additive ``[group * window, 2 * window]`` float32 mask: query i of a
    chunk (each of ``group`` heads) sees slots ``i + 1 .. i + window`` of
    its keys, the previous chunk's then its own."""
    i = torch.arange(window)[:, None]
    j = torch.arange(2 * window)[None, :]
    ok = (j > i) & (j <= i + window)
    band = torch.zeros(ok.shape).masked_fill_(~ok, float("-inf"))
    return band.repeat(group, 1).to(device)


def window_attention(q, k, v, sinks: Optional[torch.Tensor],
                     window: int) -> torch.Tensor:
    """Causal GQA over a sliding window: query i sees keys ``i - window + 1
    .. i``; ``sinks [heads]`` add ``exp(sink)`` to each head's softmax
    denominator. Exact, in chunks of ``window`` queries against the
    ``2 * window`` keys that can reach them, float32 scores; a sink scales
    a row's output by ``Z / (Z + exp(sink))``, ``Z`` the row's sum of
    exponentials."""
    b, heads, s, d = q.shape
    kv, dv = k.shape[1], v.shape[-1]
    g, n = heads // kv, s // window
    if s % window:
        raise ValueError(f"sequence {s} is not a multiple of the window "
                         f"{window}")
    qc = q.view(b, kv, g, n, window, d).permute(0, 1, 3, 2, 4, 5).reshape(
        b * kv * n, g * window, d)

    def two_chunks(t):
        p = F.pad(t, (0, 0, window, 0))
        return torch.cat([p[:, :, :s].reshape(b, kv, n, window, -1),
                          p[:, :, window:].reshape(b, kv, n, window, -1)],
                         dim=3).reshape(b * kv * n, 2 * window, -1)

    band = _band(window, g, str(q.device))[None]
    kt = two_chunks(k).transpose(1, 2)
    if q.is_cuda:
        scores = torch.baddbmm(band, qc, kt, alpha=d ** -0.5,
                               out_dtype=torch.float32)
    else:
        scores = torch.baddbmm(band, qc.float(), kt.float(),
                               alpha=d ** -0.5)
    # the first chunk has no previous one: its padding keys see nothing
    scores.view(b * kv, n, g * window, 2 * window)[:, 0, :, :window] = \
        float("-inf")
    o = torch.bmm(torch.softmax(scores, dim=-1).to(BF16), two_chunks(v))
    if sinks is not None:
        lse = torch.logsumexp(scores, dim=-1, keepdim=True)
        keep = torch.sigmoid(lse.view(b, kv, n, g, window, 1)
                             - sinks.view(1, kv, 1, g, 1, 1))
        o = (o.view(b, kv, n, g, window, dv) * keep).to(BF16)
    return o.view(b, kv, n, g, window, dv).permute(0, 1, 3, 2, 4, 5).reshape(
        b, heads, s, dv)


# --- blocks ----------------------------------------------------------------

def embed(params: Params, ids: torch.Tensor) -> torch.Tensor:
    """Token ids ``[batch, seq]`` to the feature-major float32 residual
    stream ``[hidden, batch * seq]``."""
    rows = params.embed.index_select(0, ids.reshape(-1))
    return rows.T.to(torch.float32, memory_format=torch.contiguous_format)


def attention(p: Attention, h: torch.Tensor, config: MoeTransformerConfig,
              batch: int, products: Products = contextlib.nullcontext
              ) -> torch.Tensor:
    """``h + Attn(RMSNorm(h))`` for ``batch`` sequences of equal length:
    the heads this card holds, the output projection's partial sum.
    ``products()`` is entered around the 2:4 products (q, k, v; o)."""
    call = trace.begin("sparsifyme.attention", "proj")
    try:
        x = rms_norm(h, p.norm, config.layernorm_epsilon)
        with products():
            q, k, v = linear(p.q, x), linear(p.k, x), linear(p.v, x)
        trace.mark("rope")
        rot = int(config.partial_rotary_factor * (q.shape[0] // p.heads))
        q = rope(split_heads(q, p.heads, batch), p.rope_theta, rot)
        k = rope(split_heads(k, p.kv_heads, batch), p.rope_theta, rot)
        v = split_heads(v, p.kv_heads, batch).mul_(
            config.attention_value_scale)
        trace.mark("core")
        if p.window:
            o = window_attention(q, k, v, p.sinks, p.window)
        else:
            o = full_attention(q, k, v, q.shape[-1] ** -0.5)
        trace.mark("out")
        o = o.permute(1, 3, 0, 2).reshape(-1, h.shape[1])
        with products():
            o = linear(p.o, o)
        return h + o
    finally:
        if call:
            trace.end(call)


def dense_ffn(p: DenseFfn, h: torch.Tensor, config: MoeTransformerConfig,
              products: Products = contextlib.nullcontext) -> torch.Tensor:
    """``h + W2(silu(W1 x) * W3 x)``, ``x = RMSNorm(h)``; ``products()`` is
    entered around each 2:4 product."""
    x = rms_norm(h, p.norm, config.layernorm_epsilon)
    with products():
        gu = linear(p.gate_up, x)
    gu = swiglu(gu)
    with products():
        y = linear(p.down, gu)
    return h + y


def swiglu(gu: torch.Tensor) -> torch.Tensor:
    """``silu(gate) * up`` of a fused product ``[2 * width, n]`` (gate rows
    first), bf16."""
    half = gu.shape[0] // 2
    return F.silu(gu[:half]) * gu[half:]


def moe_route(p: Moe, h: torch.Tensor, config: MoeTransformerConfig
              ) -> Tuple[torch.Tensor, Dispatch]:
    """The MoE layer's first step: ``x = RMSNorm(h)``, token-major ``[tokens,
    hidden]`` bf16; the router's float32 logits over all experts, sigmoid
    scores, the top ``num_experts_per_tok`` of score + bias with their
    scores as weights (over their sum where ``norm_topk_prob``), and the
    (token, expert) pairs of the held experts grouped by expert in token
    order, each group padded to a multiple of ``PAD_ROWS`` rows, and each
    held (token, choice)'s row (``Dispatch.slot``). With ``n_group`` > 1
    a token chooses only among the experts of its ``topk_group`` groups
    of highest score (:func:`group_limit`); ``routed_scaling_factor``
    multiplies the weights. One copy to the host (the group sizes, and,
    while someone measures, the ``moe.group_tokens`` count with them).
    Opens the ``sparsifyme.moe`` record."""
    call = trace.begin("sparsifyme.moe", "router")
    normed, x = rms_norm_layouts(h, p.norm, config.layernorm_epsilon,
                                 p.shared is not None, True)
    logits = product_f32(x, p.router.T)  # [tokens, experts]
    trace.mark("select")
    scores = logits.sigmoid_()
    top = config.num_experts_per_tok
    biased = scores + p.bias
    reach = None
    if config.n_group > 1:
        biased, kept = group_limit(biased, config.n_group,
                                   config.topk_group)
        if call is not None:  # counted only while someone measures
            held_group = (p.local.view(config.n_group, -1) >= 0).any(-1)
            reach = (kept & held_group).any(-1).sum()
    sel = torch.topk(biased, top, dim=-1).indices  # [tokens, top]
    w = scores.gather(1, sel)
    if config.norm_topk_prob:
        w = w / w.sum(-1, keepdim=True)
    if config.routed_scaling_factor is not None:
        w = w * config.routed_scaling_factor
    trace.mark("dispatch")
    held = len(p.experts)
    group = p.local[sel].reshape(-1)
    group = torch.where(group < 0, held, group)  # the others: a last group
    order = torch.argsort(group, stable=True)
    counts = torch.bincount(group, minlength=held + 1)
    if reach is None:
        rows = counts.tolist()[:held]
    else:
        host = torch.cat([counts, reach.view(1)]).tolist()
        rows = host[:held]
        trace.count("moe.group_tokens", host[-1])
    real = sum(rows)
    padded = [-(-r // PAD_ROWS) * PAD_ROWS for r in rows]
    total = sum(padded)
    counts = counts[:held]
    pad_t = (counts + PAD_ROWS - 1) // PAD_ROWS * PAD_ROWS
    first = order[:real]
    g = group[first]
    dest = (torch.cumsum(pad_t, 0) - pad_t)[g] + torch.arange(
        real, device=g.device) - (torch.cumsum(counts, 0) - counts)[g]
    index = torch.zeros(total, dtype=torch.int64, device=g.device)
    index[dest] = first // top
    weight = torch.zeros(total, dtype=torch.float32, device=g.device)
    weight[dest] = w.reshape(-1)[first]
    slot = torch.full((sel.numel(),), -1, dtype=torch.int32,
                      device=g.device)
    slot[first] = dest.to(torch.int32)
    starts = [sum(padded[:e]) for e in range(held)]
    trace.count("moe.rows", real)
    trace.count("moe.pad_rows", total - real)
    bounds = [(s0, s0 + n) for s0, n in zip(starts, padded)]
    return x, Dispatch(index, weight, bounds, rows, sel,
                       slot.view(sel.shape), call, normed)


def group_limit(biased: torch.Tensor, groups: int, keep: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """DeepSeek-V3's group limit on ``biased [tokens, experts]`` (score +
    bias): the experts fall in ``groups`` equal groups in id order, a
    group's score is the sum of its two highest, and every expert outside
    a token's ``keep`` groups of highest score is set to -inf, as the
    source's inference code masks them. Returns the masked scores and the
    kept groups ``[tokens, groups]`` bool."""
    t = biased.shape[0]
    by_group = biased.view(t, groups, -1)
    score = by_group.topk(2, dim=-1).values.sum(-1)
    kept = torch.zeros_like(score, dtype=torch.bool).scatter_(
        1, score.topk(keep, dim=-1).indices, True)
    masked = by_group.masked_fill(~kept[..., None], float("-inf"))
    return masked.view(t, -1), kept


def moe_shared(p: Moe, h: torch.Tensor, d: Dispatch) -> torch.Tensor:
    """The shared expert's step, between :func:`moe_route` and the
    combine: a new tensor, ``h`` plus the shared expert's SwiGLU of the
    layer's normed input (``d.normed``, which it drops), feature-major,
    on every token (counted by ``moe.shared_rows``)."""
    trace.mark("shared")
    gate_up, down = p.shared
    x, d.normed = d.normed, None
    y = linear(down, swiglu(linear(gate_up, x)))
    trace.count("moe.shared_rows", y.shape[1])
    return h + y


def moe_experts(p: Moe, x: torch.Tensor, d: Dispatch) -> torch.Tensor:
    """The MoE layer's second step: each held expert's SwiGLU on its rows of
    token-major ``x``, ``[rows, hidden]`` bf16 in :class:`Dispatch` order
    (two 2:4 products an expert that receives a token, on its rows
    feature-major; none for one that does not)."""
    trace.mark("experts")
    rows = x.index_select(0, d.index)
    out = []
    for (gate_up, down), (s0, s1) in zip(p.experts, d.bounds):
        if s1 > s0:
            xe = rows[s0:s1].T.contiguous()
            out.append(linear(down, swiglu(linear(gate_up, xe))).T)
    if not out:
        return rows
    return torch.cat(out)


def moe_combine(h: torch.Tensor, d: Dispatch, y: torch.Tensor
                ) -> torch.Tensor:
    """The MoE layer's last step: a new tensor, ``h`` plus each row of
    ``y`` times its weight, added at its token (the padding rows add 0):
    the combine kernel through ``d.slot`` on a card, its plain version
    through ``d.index`` on the CPU. Closes the ``sparsifyme.moe``
    record."""
    trace.mark("combine")
    try:
        if _build.use_kernel(h):
            return moe_kernel.moe_combine_cuda(h, d.slot, d.weight, y)
        return moe_kernel.moe_combine_plain(h, d.index, d.weight, y)
    finally:
        if d.call:
            trace.end(d.call)


def head(params: Params, h: torch.Tensor, config: MoeTransformerConfig,
         batch: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The final RMSNorm of every token (feature-major bf16) and each
    sequence's last-position logits ``[batch, vocab]`` (dense bf16 head)."""
    x = rms_norm(h, params.norm, config.layernorm_epsilon)
    seq = x.shape[1] // batch
    last = x[:, seq - 1::seq].contiguous()
    return x, torch.matmul(params.head, last).T


def forward(params: Params, ids: torch.Tensor,
            config: MoeTransformerConfig
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A prefill of ``ids [batch, seq]``: the final-norm hidden state of
    every token ``[hidden, batch * seq]`` and the last position's logits
    ``[batch, vocab]``."""
    batch = ids.shape[0]
    h = embed(params, ids)
    for i, (attn, ffn) in enumerate(params.layers):
        _, attend = attention_kind(config, i)
        h = attend(attn, h, config, batch)
        if isinstance(ffn, Moe):
            x, d = moe_route(ffn, h, config)
            if ffn.shared is not None:
                h = moe_shared(ffn, h, d)
            h = moe_combine(h, d, moe_experts(ffn, x, d))
        else:
            h = dense_ffn(ffn, h, config)
    return head(params, h, config, batch)
