"""Route ``dsv3mla24``: a prefill through the port's 2:4-pruned DeepSeek-V3
(``sparsifyme_tpu_torch.models.moe_transformer`` with the multi-head
latent attention of ``models/mla.py``), one card's share of each layer as
the configuration states it: its held heads, its held experts, the whole
shared expert, the whole vocabulary.

Set-up remakes every weight from the seed (``weight``) and hands it to
``init_params``, which prunes, compresses and packs the 2:4 ones through
the port's entries. A pass is one prefill of ``sequences`` x ``seq_len``
token ids drawn from the seed, through the model's public blocks in
``forward``'s order, each inside its benchmark span (and the 2:4 products
of attention and of the dense FFN inside ``proj24``); it returns the
final-norm hidden state of every token, each sequence's last-position
logits and, for each MoE layer, what that layer added to the residual
stream (``mimo24.LayerDelta``: the shared expert and the held experts'
share).

The reference (``model_refs/deepseek_v3.py``) gets the same weights remade
from the seed and cut by ``reference.keep_24``, never the program's. The
group-limited top-k is discontinuous, so a token whose choice lies within
the program's bf16 rounding of a tie may take other groups or experts than
the float32 reference, and the layers after it differ. So each MoE layer
is judged on the program's own input to that layer (its residual stream,
float32), by the reference's router, experts and shared expert, which take
the program's choice of a token only where its groups are a top
``topk_group`` of the reference's group scores and its experts a top-k
within those groups, each within ``TIE`` (the reference's ``violation``);
and the whole forward, judged on the two outputs, follows the program's
choices, each of which its layer's comparison has judged.

The functions that count the model's work (``pass_flops``,
``expert_flops``, ``expert_bytes``, ``proj24_least_s``,
``shared_least_s``) are kept here for the readers.

Spans a pass opens: ``embed``; ``attention`` (a layer's MLA: the norms,
YaRN RoPE, k and q assembly, the core and the residual); ``dense_ffn``
(layers 0-2); ``moe_route``, ``shared_expert``, ``experts`` and
``moe_combine`` (each MoE layer's four steps); ``head``; and ``proj24``
inside ``attention`` and ``dense_ffn`` around each group of 2:4 products
there (q_a, kv_a; q_b, kv_b; o; gate_up; down), entered through the
blocks' ``products`` argument. Their readers, under ``metrics/``:
``dsv3_mfu`` (``pass_flops`` over ``pass_ms``, % of 989 TFLOP/s);
``mla_attention_ms`` (device ms a pass of the ``attention`` spans, whose
``proj24`` products are their own spans); ``shared_expert_roofline``
(``shared_least_s`` over the ``shared_expert`` spans' device time); and
the MoE model readers that MiMo's cell has: ``expert_roofline``,
``proj24_roofline``, ``moe_route_ms``, ``moe_host_us``. On a program
without the model this file fails to import and the run exits 1 at once;
without the counter or the span the program readers return nothing.
"""

from __future__ import annotations

import functools
import sys
from pathlib import Path

import torch

from perfbench import data, reference, roofline, routes
from sparsifyme_tpu_torch.models import mla
from sparsifyme_tpu_torch.models import moe_transformer as mt
from sparsifyme_tpu_torch.ops import sparse24

# MiMo-V2-Flash's route: its held experts, reference spec, layer deltas,
# dense baseline and expert work are this route's too
Mimo24 = routes.resolve("mimo24", Path(__file__).resolve().parents[2])
MIMO = sys.modules[Mimo24.__module__]
REF = routes.load_file(
    Path(__file__).resolve().parents[1] / "model_refs" / "deepseek_v3.py",
    "perfbench_model_ref_deepseek_v3")
BF16 = torch.bfloat16
WEIGHT_SCALE = 0.02  # every product's weight, the embedding and the head
BIAS_SCALE = 0.01  # the router's correction bias
SPARSE = ("q_a", "q_b", "kv_a", "kv_b", "o", "gate", "up", "down")
# how far (in score + bias, or a group's score) the program's choice of a
# token may be from a group-limited top-8 of the reference's scores on the
# same input: the bf16 rounding of the router's input put 1.7-1.8% of the
# tokens' choices off one, by at most 1.54e-3 (12 seeds of the full cell on
# an H100, perfbench/flips_dsv3.py), while leaving out the group limit or
# the routed scale reads far outside (perfbench/faults_dsv3.py)
TIE = 4e-3


def moe_layers(config: dict) -> list:
    """The indices of the MoE layers."""
    return [i for i in range(config["num_hidden_layers"])
            if REF.is_moe(config, i)]


def model_config(config: dict) -> mt.MoeTransformerConfig:
    """The port's configuration from the configuration file's keys: a MoE
    layer past ``first_k_dense_replace`` at ``moe_layer_freq``, RMSNorm's
    ``rms_norm_eps``; the router scores the published count of experts;
    the card holds the run's."""
    moe = set(moe_layers(config))
    return mt.MoeTransformerConfig.from_dict(
        config, n_routed_experts=config["published"]["n_routed_experts"],
        held_experts=MIMO.held_experts(config),
        moe_layer_freq=tuple(int(i in moe) for i in
                             range(config["num_hidden_layers"])),
        layernorm_epsilon=config["rms_norm_eps"])


def weight(ctx, name: str, shape) -> torch.Tensor:
    """Weight ``name`` as the seed makes it, bf16 on the run's device:
    norms 1, the router's bias 0.01 x unit normal, every other weight 0.02
    x unit normal."""
    if name == "norm" or name.endswith("_norm"):
        return torch.ones(shape, dtype=BF16, device=ctx.device)
    rows, cols = shape if len(shape) == 2 else (1, shape[0])
    w = data.weight_b(rows, cols, ctx.seed, "dsv3mla24." + name, ctx.device)
    scale = BIAS_SCALE if name.endswith("router_bias") else WEIGHT_SCALE
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
        data.stream_seed(ctx.seed, "dsv3mla24.ids"))
    return torch.randint(0, ctx.config["vocab_size"],
                         (t["sequences"], t["seq_len"]), generator=gen,
                         device=ctx.device)


def _products(cfg: mt.MoeTransformerConfig, layer: int) -> list:
    """``(M, K)`` of layer ``layer``'s 2:4 products in the ``proj24``
    spans: MLA's five, and a dense layer's gate_up and down."""
    out = [mla.weight_shape(cfg, n) for n in mla.PRODUCTS]
    if not cfg.moe_layer_freq[layer]:
        hid, width = cfg.hidden_size, cfg.intermediate_size
        out += [(2 * width, hid), (hid, width)]
    return out


class Dsv3Mla24(Mimo24):
    """The model made and packed once in set-up; the window runs one
    prefill a pass. MiMo's route gives the dense baseline and the routed
    experts' work (``expert_flops``, ``expert_bytes``)."""

    # --- the model's work, from configuration and traffic ---------------

    @staticmethod
    def pass_flops(config: dict, traffic: dict) -> float:
        """A pass's model work: the kept 2:4 products (MLA's five, the
        dense FFNs, the shared expert on every token, the routed experts
        at the expected rows: each token's ``num_experts_per_tok``
        choices, the held share of them), the dense router, the causal
        attention core (qk and v widths) and the last positions' dense
        head."""
        cfg = model_config(config)
        b, s = traffic["sequences"], traffic["seq_len"]
        t, hid = b * s, cfg.hidden_size
        qk = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
        shared = 3 * cfg.moe_intermediate_size * cfg.n_shared_experts * hid
        total = 2.0 * b * hid * cfg.vocab_size
        for i in range(cfg.num_hidden_layers):
            total += float(t) * sum(m * k for m, k in _products(cfg, i))
            pairs = s * (s + 1) / 2
            total += 2.0 * b * cfg.num_attention_heads * pairs * (
                qk + cfg.v_head_dim)
            if cfg.moe_layer_freq[i]:
                rows = t * cfg.num_experts_per_tok * len(
                    cfg.held_experts) / cfg.n_routed_experts
                total += 2.0 * t * hid * cfg.n_routed_experts
                total += float(t) * shared
                total += Dsv3Mla24.expert_flops(config, rows)
        return total

    @staticmethod
    def _least_s(shapes, n: int) -> float:
        return sum(roofline.bound_s(roofline.kept_flops_24(m, n, k),
                                    roofline.spmm24_bytes(m, n, k))
                   for m, k in shapes)

    @staticmethod
    def proj24_least_s(config: dict, traffic: dict) -> float:
        """A pass's least time for its 2:4 products in the ``proj24``
        spans (MLA's q_a, kv_a, q_b, kv_b and o of every layer, the dense
        layers' gate_up and down): each call's kept products at the bf16
        peak or its bytes (A at 1.125 B a logical element, B, C) at HBM
        bandwidth, the larger."""
        cfg = model_config(config)
        n = traffic["sequences"] * traffic["seq_len"]
        return sum(Dsv3Mla24._least_s(_products(cfg, i), n)
                   for i in range(cfg.num_hidden_layers))

    @staticmethod
    def shared_least_s(config: dict, traffic: dict) -> float:
        """A pass's least time for the shared expert's two 2:4 products
        (gate_up ``[2 * width, hidden]``, down ``[hidden, width]`` on every
        token) in every MoE layer, as :meth:`proj24_least_s` counts a
        call."""
        n = traffic["sequences"] * traffic["seq_len"]
        hid = config["hidden_size"]
        width = config["moe_intermediate_size"] * config["n_shared_experts"]
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
        with routes.span(traced, "embed"):
            h = mt.embed(params, ids)
        for attn, ffn in params.layers:
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
        spec = MIMO.ref_spec(ctx.config)
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
        params, _, _ = state
        attn, _ = params.layers[0]
        dense = next(f for _, f in params.layers if isinstance(f, mt.DenseFfn))
        moe = next(f for _, f in params.layers if isinstance(f, mt.Moe))
        named = [(n, getattr(attn, n)) for n in mla.PRODUCTS]
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


ROUTE = Dsv3Mla24
