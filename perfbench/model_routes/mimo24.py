"""Route ``mimo24``: a prefill through the port's 2:4-pruned MiMo-V2-Flash
(``sparsifyme_tpu_torch.models.moe_transformer``), one card's share of
each layer as the configuration states it: its held heads, its held
experts, the whole vocabulary.

Set-up remakes every weight from the seed (``weight``) and hands it to
``init_params``, which prunes, compresses and packs the 2:4 ones through
the port's entries. A pass is one prefill of ``sequences`` x ``seq_len``
token ids drawn from the seed, through the model's public blocks in
``forward``'s order, each inside its benchmark span (and the 2:4
products of attention and of the dense FFN inside ``proj24``); it returns
the final-norm hidden state of every token, each sequence's last-position
logits and, for each MoE layer, what that layer added to the residual
stream (:class:`LayerDelta`, formed when it is judged).

The reference (``model_refs/mimo.py``) gets the same weights remade from
the seed and cut by ``reference.keep_24``, never the program's. Top-k
selection is discontinuous, so a token whose 8th and 9th scores lie
within the program's bf16 rounding may take another expert than the
float32 reference, and once taken the layers after it differ. So each
MoE layer is judged on the program's own input to that layer (its
residual stream, float32), by the reference's router and experts, which
take the program's choice of a token only where that choice is a top-8 of
the reference's own scores within ``TIE``; and the whole forward, judged
on the two outputs, follows the program's choices, each of which its
layer's comparison has judged.

The functions that count the model's work (``pass_flops``,
``expert_flops``, ``expert_bytes``, ``proj24_least_s``) are kept here for
the readers.

Spans a pass opens: ``embed``; ``attention`` (a layer's norm, RoPE, core
and residual); ``dense_ffn`` (layer 0); ``moe_route``, ``experts`` and
``moe_combine`` (each MoE layer's three steps); ``head``; and ``proj24``
inside ``attention`` and ``dense_ffn`` around each group of 2:4 products
there (q, k, v; o; gate_up; down), entered through the blocks'
``products`` argument. Their readers, under ``metrics/``: ``mimo_mfu``
(``pass_flops`` over ``pass_ms``, % of 989 TFLOP/s); ``expert_roofline``
(``expert_flops`` / ``expert_bytes`` over the ``moe.rows`` counter and
the ``experts`` spans' device time, which holds each expert's column
gather and SwiGLU besides K3); ``proj24_roofline`` (``proj24_least_s``
over the ``proj24`` spans' device time); ``moe_route_ms`` (device time of
``moe_route`` and ``moe_combine`` a pass); ``moe_host_us`` (host µs a
``sparsifyme.moe`` record). On a program without the model this file
fails to import and the run exits 1 at once; without the counter or the
span the program readers return nothing.
"""

from __future__ import annotations

import functools
from pathlib import Path

import torch

from perfbench import data, reference, roofline, routes
from sparsifyme_tpu_torch.models import moe_transformer as mt
from sparsifyme_tpu_torch.ops import sparse24

REF = routes.load_file(
    Path(__file__).resolve().parents[1] / "model_refs" / "mimo.py",
    "perfbench_model_ref_mimo")
BF16 = torch.bfloat16
WEIGHT_SCALE = 0.02  # every product's weight, the embedding and the head
BIAS_SCALE = 0.01  # the router's correction bias
SPARSE = ("q", "k", "v", "o", "gate", "up", "down")  # cut 2:4
# how far (in score + bias) the program's choice of a token may be from a
# top-8 of the reference's scores on the same input: the bf16 rounding of
# the router's input put 1.7% of the tokens' choices off a top-8, by at
# most 1.04e-3 (4 seeds of the full cell on an H100, perfbench/flips.py),
# while leaving out the correction bias (0.01 x unit normal) reads far
# outside (perfbench/faults.py)
TIE = 4e-3


def held_experts(config: dict) -> tuple:
    """The experts this card holds: the first ``n_routed_experts`` (as
    run) of the router's published count."""
    return tuple(range(config["n_routed_experts"]))


def model_config(config: dict) -> mt.MoeTransformerConfig:
    """The port's configuration from the configuration file's keys: the
    router scores the published count of experts; the card holds the
    run's."""
    if len(config["hybrid_layer_pattern"]) != config["num_hidden_layers"]:
        raise ValueError("hybrid_layer_pattern does not give every layer")
    return mt.MoeTransformerConfig.from_dict(
        config, n_routed_experts=config["published"]["n_routed_experts"],
        held_experts=held_experts(config))


def ref_spec(config: dict) -> dict:
    """What the plain reference reads: the file's keys, the router's
    width and the held experts."""
    return dict(config,
                router_experts=config["published"]["n_routed_experts"],
                held_experts=list(held_experts(config)))


def weight(ctx, name: str, shape) -> torch.Tensor:
    """Weight ``name`` as the seed makes it, bf16 on the run's device:
    norms 1, sinks unit normal, the router's bias 0.01 x unit normal, every
    other weight 0.02 x unit normal."""
    if name == "norm" or name.endswith("_norm"):
        return torch.ones(shape, dtype=BF16, device=ctx.device)
    rows, cols = shape if len(shape) == 2 else (1, shape[0])
    w = data.weight_b(rows, cols, ctx.seed, "mimo24." + name, ctx.device)
    if name.endswith(".sinks"):
        return w.reshape(shape)
    scale = BIAS_SCALE if name.endswith("router_bias") else WEIGHT_SCALE
    return (w * scale).reshape(shape)


def moe_layers(config: dict) -> list:
    """The indices of the MoE layers."""
    return [i for i, f in enumerate(config["moe_layer_freq"]) if f]


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
        data.stream_seed(ctx.seed, "mimo24.ids"))
    return torch.randint(0, ctx.config["vocab_size"],
                         (t["sequences"], t["seq_len"]), generator=gen,
                         device=ctx.device)


class LayerDelta:
    """What a MoE layer added to the residual stream, ``after - before``
    (feature-major float32), formed a block of rows at a time as the
    comparison reads it, so the timed pass computes nothing for it."""

    def __init__(self, before: torch.Tensor, after: torch.Tensor):
        self.before, self.after = before, after
        self.shape = after.shape

    def __getitem__(self, rows) -> torch.Tensor:
        return self.after[rows] - self.before[rows]


class Mimo24(routes.Route):
    """The model made and packed once in set-up; the window runs one
    prefill a pass."""

    dense_baseline = True

    def __init__(self):
        self._ref = None  # (seed, control, outputs, control outputs)
        # the last pass's MoE layers: (input, output, choices) each
        self._moe = None

    # --- the model's work, from configuration and traffic ---------------

    @staticmethod
    def expert_flops(config: dict, rows: float) -> float:
        """Kept products of ``rows`` token rows through one expert: gate
        and up (``[2 * width, hidden]``) then down, half of 2 * M * N * K
        each."""
        hid, width = config["hidden_size"], config["moe_intermediate_size"]
        return float(rows) * 3 * width * hid

    @staticmethod
    def expert_bytes(config: dict, rows: float, layers: float) -> float:
        """The held experts' least bytes over ``layers`` MoE layers and
        ``rows`` token rows in all: every held expert's packed weights
        (1.125 B a logical element) once a layer, and each row's B and C
        (bf16) of both products."""
        hid, width = config["hidden_size"], config["moe_intermediate_size"]
        weights = config["n_routed_experts"] * 3 * width * hid
        per_row = (hid + 2 * width) + (width + hid)
        return (layers * weights * roofline.SP24_BYTES_PER_ELEMENT
                + float(rows) * per_row * roofline.BF16)

    @staticmethod
    def pass_flops(config: dict, traffic: dict) -> float:
        """A pass's model work: the kept 2:4 products (experts at the
        expected rows: each token's ``num_experts_per_tok`` choices, the
        held share of them), the dense router, the attention core over the
        causal or windowed pairs, and the last positions' dense head."""
        cfg = model_config(config)
        b, s = traffic["sequences"], traffic["seq_len"]
        t, hid = b * s, cfg.hidden_size
        total = 2.0 * b * hid * cfg.vocab_size
        for i in range(cfg.num_hidden_layers):
            heads, kv, dqk, dv, window, _, _ = cfg.attention_shape(i)
            total += float(t) * hid * (heads * dqk + kv * (dqk + dv)
                                       + heads * dv)
            w = window or s
            pairs = w * (w + 1) / 2 + (s - w) * w
            total += 2.0 * b * heads * pairs * (dqk + dv)
            if cfg.moe_layer_freq[i]:
                rows = t * cfg.num_experts_per_tok * len(
                    cfg.held_experts) / cfg.n_routed_experts
                total += 2.0 * t * hid * cfg.n_routed_experts
                total += Mimo24.expert_flops(config, rows)
            else:
                total += float(t) * 3 * cfg.intermediate_size * hid
        return total

    @staticmethod
    def proj24_least_s(config: dict, traffic: dict) -> float:
        """A pass's least time for its 2:4 products outside the experts (q,
        k, v and o of every layer, the dense layer's gate_up and down):
        each call's kept products at the bf16 peak or its bytes (A at
        1.125 B a logical element, B, C) at HBM bandwidth, the larger."""
        cfg = model_config(config)
        n, hid = traffic["sequences"] * traffic["seq_len"], cfg.hidden_size
        shapes = []
        for i in range(cfg.num_hidden_layers):
            heads, kv, dqk, dv, _, _, _ = cfg.attention_shape(i)
            shapes += [(heads * dqk, hid), (kv * dqk, hid), (kv * dv, hid),
                       (hid, heads * dv)]
            if not cfg.moe_layer_freq[i]:
                shapes += [(2 * cfg.intermediate_size, hid),
                           (hid, cfg.intermediate_size)]
        return sum(roofline.bound_s(roofline.kept_flops_24(m, n, k),
                                    roofline.spmm24_bytes(m, n, k))
                   for m, k in shapes)

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
                h = mt.attention(attn, h, cfg, batch, products)
            if isinstance(ffn, mt.Moe):
                with routes.span(traced, "moe_route"):
                    x, d = mt.moe_route(ffn, h, cfg)
                with routes.span(traced, "experts"):
                    ys = mt.moe_experts(ffn, x, d)
                with routes.span(traced, "moe_combine"):
                    out = mt.moe_combine(h, d, ys)
                moe.append((h, out, d.selected))
                h, x, ys = out, None, None
            else:
                with routes.span(traced, "dense_ffn"):
                    h = mt.dense_ffn(ffn, h, cfg, products)
        with routes.span(traced, "head"):
            outs = list(mt.head(params, h, cfg, batch))
        self._moe = moe
        return outs + [LayerDelta(a, b) for a, b, _ in moe]

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
                         ctx.config["layernorm_epsilon"])
        ref = REF.moe(x, spec, layer, wf, False, sel, TIE).T.contiguous()
        ctl = REF.moe(x, spec, layer, wf, True, sel, TIE).T.contiguous() \
            if control else None
        return ref, ctl

    def dense_inputs(self, ctx, layers, state):
        params, ids, cfg = state
        return mt.densify(params), ids, cfg

    def dense_pass(self, inputs):
        params, ids, cfg = inputs
        return list(mt.forward(params, ids, cfg))

    def designs(self, state):
        """K3's tile for each kind of product (n a multiple of 64, as every
        call's is)."""
        params, _, _ = state
        attn, _ = params.layers[0]
        dense = next(f for _, f in params.layers if isinstance(f, mt.DenseFfn))
        moe = next(f for _, f in params.layers if isinstance(f, mt.Moe))
        out = []
        for name, w in (("q", attn.q), ("k", attn.k), ("v", attn.v),
                        ("o", attn.o), ("ffn.gate_up", dense.gate_up),
                        ("ffn.down", dense.down),
                        ("expert.gate_up", moe.experts[0][0]),
                        ("expert.down", moe.experts[0][1])):
            b = torch.empty((w.shape[1], 64), dtype=BF16,
                            device=w.values0.device)
            design = sparse24.spmm24_design(w, b, out_dtype=BF16)
            out.append(f"{name} {design}")
        return out


ROUTE = Mimo24
