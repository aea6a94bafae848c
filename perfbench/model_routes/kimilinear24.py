"""Route ``kimilinear24``: a prefill through the port's 2:4-pruned Kimi
Linear (``sparsifyme_tpu_torch.models.moe_transformer`` with the Kimi Delta
Attention of ``models/kda.py`` and the NoPE multi-head latent attention of
``models/mla.py``), one card's share of each layer as the configuration
states it: every head, its held experts, the whole shared expert, the
dense layer, the whole vocabulary.

Set-up remakes every weight from the seed (``weight``) and hands it to
``init_params``, which prunes, compresses and packs the 2:4 ones through
the port's entries. A pass is one prefill of ``sequences`` x ``seq_len``
token ids drawn from the seed, through the model's public blocks in
``forward``'s order, each inside its benchmark span; it returns the
final-norm hidden state of every token, each sequence's last-position
logits and, for each MoE layer, what that layer added to the residual
stream (``mimo24.LayerDelta``: the shared expert and the held experts'
share).

The reference (``model_refs/kimi_linear.py``) gets the same weights remade
from the seed and cut by ``reference.keep_24``, never the program's, and
computes KDA as the token recurrence itself. As in ``dsv3mla24``, each MoE
layer is judged on the program's own input to that layer by the
reference's router, experts and shared expert, which take the program's
choice of a token only where it is a top-8 of the reference's scores
within ``TIE``; the whole forward, judged on the two outputs, follows the
program's choices.

The functions that count the model's work (``pass_flops``,
``expert_flops``, ``expert_bytes``, ``proj24_least_s``,
``shared_least_s``, ``kda_least_s``) are kept here for the readers.

Spans a pass opens: ``embed``; ``kda`` (a KDA layer: the input norm, the
low-rank gate products, the convolution, SiLU and L2 norms, decay and
beta, the gated output norm, the residual), with ``kda_core`` inside it
around the recurrence (entered through the block's ``core`` argument);
``attention`` (an MLA layer: the norms, the k and q assembly, the core,
the residual); ``dense_ffn`` (layer 0); ``moe_route``, ``shared_expert``,
``experts`` and ``moe_combine`` (each MoE layer's four steps); ``head``;
and ``proj24`` inside ``kda``, ``attention`` and ``dense_ffn`` around each
group of 2:4 products there (qkv; o; q, kv_a; kv_b; o; gate_up; down),
entered through the blocks' ``products`` argument. Their readers, under
``metrics/``: ``mimo_mfu`` (``pass_flops`` over ``pass_ms``, % of 989
TFLOP/s, as for MiMo-V2-Flash); ``kda_ms`` (device ms a pass of the
``kda`` and ``kda_core`` spans); ``kda_roofline`` (``kda_least_s`` of the head-tokens the
program's ``kda.tokens`` counter saw over the ``kda_core`` spans' device
time); ``mla_attention_ms`` (the ``attention`` spans); and the MoE model
readers of the other model cells. On a program without ``models/kda.py``
this file fails to import and the run exits 1 at once; without the
counter or the span the program readers return nothing.
"""

from __future__ import annotations

import functools
import math
import sys
from pathlib import Path

import torch

from perfbench import data, reference, roofline, routes
from sparsifyme_tpu_torch.models import kda
from sparsifyme_tpu_torch.models import mla
from sparsifyme_tpu_torch.models import moe_transformer as mt
from sparsifyme_tpu_torch.ops import sparse24

# DeepSeek-V3's route: its least-time sum, and through it MiMo's layer
# deltas and dense baseline, are this route's too
Dsv3Mla24 = routes.resolve("dsv3mla24", Path(__file__).resolve().parents[2])
MIMO = sys.modules[Dsv3Mla24.__module__].MIMO
REF = routes.load_file(
    Path(__file__).resolve().parents[1] / "model_refs" / "kimi_linear.py",
    "perfbench_model_ref_kimi_linear")
BF16 = torch.bfloat16
WEIGHT_SCALE = 0.02  # every product's weight, the embedding and the head
BIAS_SCALE = 0.01  # the router's correction bias
CONV_BOUND = 0.5  # the short convolutions' U(-0.5, 0.5)
DT_RANGE = (1e-3, 0.1)  # dt, log-uniform, whose inverse softplus is dt_bias
A_RANGE = (1.0, 16.0)  # exp(A_log), uniform
SPARSE = ("q", "k", "v", "o", "kv_a", "kv_b", "gate", "up", "down")
# how far (in score + bias) the program's choice of a token may be from a
# top-8 of the reference's scores on the same input (perfbench/
# flips_kimi.py reads the largest such violation on the full cell; MiMo's
# and DeepSeek-V3's routes keep the same margin)
TIE = 4e-3
KDA_CHUNK = 64  # the chunk that the recurrence's least work counts in


def kda_flops(d: int) -> float:
    """The KDA recurrence's least work a head-token at head dim ``d`` (q, k
    and v): ``4 d^2 + 2 C (2 d)`` FLOP, C the chunk."""
    return 4.0 * d * d + 2.0 * KDA_CHUNK * 2 * d


def held_experts(config: dict) -> tuple:
    """The experts this card holds: the first ``num_experts`` (as run) of
    the router's published count."""
    return tuple(range(config["num_experts"]))


def ref_spec(config: dict) -> dict:
    """What the plain reference reads: the file's keys, the router's width
    and the held experts."""
    return dict(config, router_experts=config["published"]["num_experts"],
                held_experts=list(held_experts(config)))


def moe_layers(config: dict) -> list:
    """The indices of the MoE layers."""
    return [i for i in range(config["num_hidden_layers"])
            if REF.is_moe(config, i)]


def kda_layers(config: dict) -> list:
    """The indices (0-based) of the KDA layers."""
    return [i for i in range(config["num_hidden_layers"])
            if REF.is_kda(config, i)]


def model_config(config: dict) -> mt.MoeTransformerConfig:
    """The port's configuration from the configuration file's keys (Kimi's
    names mapped onto the port's fields): a MoE layer past
    ``first_k_dense_replace``; the router scores the published count of
    experts; the card holds the run's."""
    moe = set(moe_layers(config))
    return mt.MoeTransformerConfig.from_dict(
        config, n_routed_experts=config["published"]["num_experts"],
        held_experts=held_experts(config),
        moe_layer_freq=tuple(int(i in moe) for i in
                             range(config["num_hidden_layers"])),
        num_experts_per_tok=config["num_experts_per_token"],
        norm_topk_prob=config["moe_renormalize"],
        n_group=config["num_expert_group"],
        n_shared_experts=config["num_shared_experts"],
        layernorm_epsilon=config["rms_norm_eps"])


def _uniform(ctx, name: str, shape, lo: float, hi: float) -> torch.Tensor:
    gen = torch.Generator(device=ctx.device).manual_seed(
        data.stream_seed(ctx.seed, "kimilinear24." + name))
    return torch.rand(shape, generator=gen, device=ctx.device,
                      dtype=torch.float32) * (hi - lo) + lo


def weight(ctx, name: str, shape) -> torch.Tensor:
    """Weight ``name`` as the seed makes it, on the run's device: norms 1,
    ``A_log`` ln U(1, 16) and ``dt_bias`` the inverse softplus of a
    log-uniform dt in [0.001, 0.1] (float32), the convolutions' weights
    U(-0.5, 0.5), the router's bias 0.01 x unit normal, every other weight
    0.02 x unit normal (bf16)."""
    part = name.rsplit(".", 1)[-1]
    if name == "norm" or part.endswith("norm"):
        return torch.ones(shape, dtype=BF16, device=ctx.device)
    if part == "A_log":
        return _uniform(ctx, name, shape, *A_RANGE).log_()
    if part == "dt_bias":
        lo, hi = (math.log(x) for x in DT_RANGE)
        dt = _uniform(ctx, name, shape, lo, hi).exp_()
        return dt + torch.log(-torch.expm1(-dt))
    if part.endswith("_conv"):
        return _uniform(ctx, name, shape, -CONV_BOUND, CONV_BOUND).to(BF16)
    rows, cols = shape if len(shape) == 2 else (1, shape[0])
    w = data.weight_b(rows, cols, ctx.seed, "kimilinear24." + name,
                      ctx.device)
    scale = BIAS_SCALE if part == "router_bias" else WEIGHT_SCALE
    return (w * scale).reshape(shape)


def kept_weight(ctx, name: str, shape) -> torch.Tensor:
    """The reference's weight: :func:`weight`, 2:4-kept where the program
    prunes it."""
    w = weight(ctx, name, shape)
    return reference.keep_24(w) if name.rsplit(".", 1)[-1] in SPARSE else w


def token_ids(ctx) -> torch.Tensor:
    """``[sequences, seq_len]`` ids drawn from the seed over the whole
    vocabulary."""
    t = ctx.traffic
    gen = torch.Generator(device=ctx.device).manual_seed(
        data.stream_seed(ctx.seed, "kimilinear24.ids"))
    return torch.randint(0, ctx.config["vocab_size"],
                         (t["sequences"], t["seq_len"]), generator=gen,
                         device=ctx.device)


def _products(cfg: mt.MoeTransformerConfig, layer: int) -> list:
    """``(M, K)`` of layer ``layer``'s 2:4 products in the ``proj24``
    spans: KDA's qkv and o, or MLA's q, kv_a, kv_b and o; and a dense
    layer's gate_up and down."""
    if cfg.attention_kind_of(layer) == "kda":
        heads, d, _ = kda.dims(cfg)
        out = [(3 * heads * d, cfg.hidden_size), (cfg.hidden_size,
                                                  heads * d)]
    else:
        out = [mla.weight_shape(cfg, n) for n in mla.products(cfg)]
    if not cfg.moe_layer_freq[layer]:
        hid, width = cfg.hidden_size, cfg.intermediate_size
        out += [(2 * width, hid), (hid, width)]
    return out


class KimiLinear24(Dsv3Mla24):
    """The model made and packed once in set-up; the window runs one
    prefill a pass. MiMo's route gives the dense baseline and the routed
    experts' work per row (``expert_flops``)."""

    # --- the model's work, from configuration and traffic ---------------

    @staticmethod
    def expert_bytes(config: dict, rows: float, layers: float) -> float:
        """The held experts' least bytes, as ``mimo24``'s count them, over
        the ``num_experts`` held."""
        return MIMO.Mimo24.expert_bytes(
            dict(config, n_routed_experts=config["num_experts"]), rows,
            layers)

    @staticmethod
    def kda_least_s(config: dict, head_tokens: float) -> float:
        """The least time of the KDA recurrence over ``head_tokens`` tokens
        x heads: the larger of its bytes (q, k, v, the decay's input and o
        at 2 B an element, beta at 4 B) at HBM bandwidth and its work
        (``4 d^2 + 2 C (2 d)`` FLOP a head-token, C the 64-token chunk) at
        the bf16 peak; fixed by the block's inputs and outputs, whatever
        kernel computes it."""
        d = config["linear_attn_config"]["head_dim"]
        flops = float(head_tokens) * kda_flops(d)
        nbytes = float(head_tokens) * (5 * d * roofline.BF16 + 4)
        return roofline.bound_s(flops, nbytes)

    @staticmethod
    def pass_flops(config: dict, traffic: dict) -> float:
        """A pass's model work: the kept 2:4 products (KDA's qkv and o,
        MLA's four, the dense FFN, the shared expert on every token, the
        routed experts at the expected rows), the dense low-rank gate
        products and router, the KDA recurrence's least count, the causal
        MLA core and the last positions' dense head."""
        cfg = model_config(config)
        b, s = traffic["sequences"], traffic["seq_len"]
        t, hid = b * s, cfg.hidden_size
        heads, d, _ = kda.dims(cfg)
        qk = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
        shared = 3 * cfg.moe_intermediate_size * cfg.n_shared_experts * hid
        total = 2.0 * b * hid * cfg.vocab_size
        for i in range(cfg.num_hidden_layers):
            total += float(t) * sum(m * k for m, k in _products(cfg, i))
            if cfg.attention_kind_of(i) == "kda":
                total += 2.0 * t * ((2 * d + heads) * hid + 2 * heads * d * d)
                total += float(t) * heads * kda_flops(d)
            else:
                pairs = s * (s + 1) / 2
                total += 2.0 * b * cfg.num_attention_heads * pairs * (
                    qk + cfg.v_head_dim)
            if cfg.moe_layer_freq[i]:
                rows = t * cfg.num_experts_per_tok * len(
                    cfg.held_experts) / cfg.n_routed_experts
                total += 2.0 * t * hid * cfg.n_routed_experts
                total += float(t) * shared
                total += KimiLinear24.expert_flops(config, rows)
        return total

    @staticmethod
    def proj24_least_s(config: dict, traffic: dict) -> float:
        """A pass's least time for its 2:4 products in the ``proj24``
        spans (KDA's qkv and o, MLA's q, kv_a, kv_b and o, the dense
        layer's gate_up and down), each call as ``dsv3mla24`` counts one."""
        cfg = model_config(config)
        n = traffic["sequences"] * traffic["seq_len"]
        return sum(Dsv3Mla24._least_s(_products(cfg, i), n)
                   for i in range(cfg.num_hidden_layers))

    @staticmethod
    def shared_least_s(config: dict, traffic: dict) -> float:
        """A pass's least time for the shared expert's two 2:4 products in
        every MoE layer, as :meth:`proj24_least_s` counts a call."""
        n = traffic["sequences"] * traffic["seq_len"]
        hid = config["hidden_size"]
        width = config["moe_intermediate_size"] * config["num_shared_experts"]
        return len(moe_layers(config)) * Dsv3Mla24._least_s(
            [(2 * width, hid), (hid, width)], n)

    # --- the run ------------------------------------------------------------

    def setup(self, ctx, layers):
        cfg = model_config(ctx.config)
        params = mt.init_params(cfg, functools.partial(weight, ctx))
        return params, token_ids(ctx), cfg

    def run_pass(self, state, traced):
        params, ids, cfg = state
        self._moe = None  # the last pass's layers go before this one's come
        moe = []
        batch = ids.shape[0]
        products = functools.partial(routes.span, traced, "proj24")
        core = functools.partial(routes.span, traced, "kda_core")
        with routes.span(traced, "embed"):
            h = mt.embed(params, ids)
        for i, (attn, ffn) in enumerate(params.layers):
            if cfg.attention_kind_of(i) == "kda":
                with routes.span(traced, "kda"):
                    h = kda.kda_attention(attn, h, cfg, batch, products,
                                          core)
            else:
                with routes.span(traced, "attention"):
                    h = mla.mla_attention(attn, h, cfg, batch, products)
            if isinstance(ffn, mt.Moe):
                with routes.span(traced, "moe_route"):
                    x, d = mt.moe_route(ffn, h, cfg)
                with routes.span(traced, "shared_expert"):
                    hs = mt.moe_shared(ffn, h, d)
                with routes.span(traced, "experts"):
                    ys = mt.moe_experts(ffn, x, d)
                with routes.span(traced, "moe_combine"):
                    out = mt.moe_combine(hs, d, ys)
                moe.append((h, out, d.selected))
                h, hs, x, ys = out, None, None, None
            else:
                with routes.span(traced, "dense_ffn"):
                    h = mt.dense_ffn(ffn, h, cfg, products)
        with routes.span(traced, "head"):
            outs = list(mt.head(params, h, cfg, batch))
        self._moe = moe
        return outs + [MIMO.LayerDelta(a, b) for a, b, _ in moe]

    def outputs(self, ctx, layers):
        return 2 + len(moe_layers(ctx.config))

    def reference(self, ctx, layers, i, control):
        """Outputs 0 and 1: both from one forward of the plain reference
        (and of its control) that follows the program's choices, kept until
        the second is judged. Output ``2 + j``: MoE layer j's reference on
        the program's input to it, taking the program's choices within
        ``TIE``. The last pass's layers are dropped after the last."""
        spec = ref_spec(ctx.config)
        wf = functools.partial(kept_weight, ctx)
        moe = self._moe or []
        if i < 2:
            if self._ref is None or self._ref[:2] != (ctx.seed, control):
                self._ref = None
                ids = token_ids(ctx)
                choices = [sel for _, _, sel in moe] or None
                ref = REF.forward(ids, spec, wf, choices=choices)
                ctl = REF.forward(ids, spec, wf, control=True,
                                  choices=choices) if control else None
                self._ref = (ctx.seed, control, ref, ctl)
            _, _, ref, ctl = self._ref
            if i == 1:
                self._ref = None
            return ref[i], ctl[i] if ctl is not None else None
        j = i - 2
        if i == self.outputs(ctx, layers) - 1:
            self._moe = None
        if j >= len(moe):  # the pass returned no such layer
            return torch.zeros(0), None
        before, _, sel = moe[j]
        layer = moe_layers(ctx.config)[j]
        hid = ctx.config["hidden_size"]
        x = REF.rms_norm(before.T, wf(f"{layer}.ffn_norm", (hid,)),
                         ctx.config["rms_norm_eps"])
        ref = REF.moe(x, spec, layer, wf, False, sel, TIE).T.contiguous()
        ctl = REF.moe(x, spec, layer, wf, True, sel, TIE).T.contiguous() \
            if control else None
        return ref, ctl

    def designs(self, state):
        """K3's tile for each kind of product (n a multiple of 64, as every
        call's is)."""
        params, _, cfg = state
        kda_block = next(a for a, _ in params.layers if isinstance(a, kda.Kda))
        mla_block = next(a for a, _ in params.layers if isinstance(a, mla.Mla))
        dense = next(f for _, f in params.layers if isinstance(f, mt.DenseFfn))
        moe = next(f for _, f in params.layers if isinstance(f, mt.Moe))
        named = [("kda.qkv", kda_block.qkv), ("kda.o", kda_block.o)]
        named += [("mla." + n, getattr(mla_block, n))
                  for n in mla.products(cfg)]
        named += [("ffn.gate_up", dense.gate_up), ("ffn.down", dense.down),
                  ("expert.gate_up", moe.experts[0][0]),
                  ("expert.down", moe.experts[0][1]),
                  ("shared.gate_up", moe.shared[0]),
                  ("shared.down", moe.shared[1])]
        out = []
        for name, w in named:
            b = torch.empty((w.shape[1], 64), dtype=BF16,
                            device=w.values0.device)
            design = sparse24.spmm24_design(w, b, out_dtype=BF16)
            out.append(f"{name} {design}")
        return out


ROUTE = KimiLinear24
