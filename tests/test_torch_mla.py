"""DeepSeek-V3 on the port (``models/mla.py`` and the group-limited router,
routed scale and shared expert of ``models/moe_transformer.py``) against
the benchmark's plain float32 reference
(``perfbench/model_refs/deepseek_v3.py``), on the CPU at a small size:
hidden 256, the published latents (q 1536, kv 512) and heads (128 nope +
64 rope dims, v 128), so that the attention's scores spread as they do at
full size, 2 of 8 heads, 4 held of 32 experts in 4 groups of 8 (2 kept),
top-4, 5 layers of which the first 2 dense, 2 sequences of 64 tokens. Weights
come from the benchmark route's seeded generator
(``perfbench/model_routes/dsv3mla24.py``), 2:4-kept for the reference by
``reference.keep_24``.

Tolerances, as in ``test_torch_moe_transformer.py``: a block's products
take bf16 operands and give bf16 results (about 2**-9 relative each), so
one block reads 3-6e-3 against the float32 reference; 1e-2 holds each
block with room. A MoE layer compares the tokens whose choice is the
reference's: a group or an expert flips where two scores lie within the
rounding of the bf16 input.
"""

import dataclasses
import functools
import json
import math
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from perfbench import faults_dsv3, reference
from perfbench.model_routes import dsv3mla24
from sparsifyme_tpu_torch.models import mla
from sparsifyme_tpu_torch.models import moe_transformer as mt
from sparsifyme_tpu_torch.utils import trace

REF = dsv3mla24.REF
SEED = 2 ** 31 + 11
BATCH, SEQ = 2, 64
CONFIG = json.loads((Path(__file__).resolve().parents[1] / "perfbench"
                     / "configs" / "deepseek-v3-ep32.json").read_text())
SMALL = dict(
    CONFIG, hidden_size=256, intermediate_size=512,
    moe_intermediate_size=128, vocab_size=512, num_hidden_layers=5,
    first_k_dense_replace=2, num_attention_heads=2, num_key_value_heads=2,
    n_routed_experts=4,
    num_experts_per_tok=4, n_group=4, topk_group=2,
    published={"n_routed_experts": 32})
TOL = 1e-2


def _ctx(config=SMALL, seed=SEED):
    return SimpleNamespace(device=torch.device("cpu"), seed=seed,
                           config=config, rank=0,
                           traffic={"sequences": BATCH, "seq_len": SEQ})


@pytest.fixture(scope="module")
def small():
    ctx = _ctx()
    params, ids, cfg = dsv3mla24.Dsv3Mla24().setup(ctx, [])
    return SimpleNamespace(ctx=ctx, params=params, ids=ids, cfg=cfg,
                           spec=dsv3mla24.MIMO.ref_spec(SMALL),
                           weight=functools.partial(dsv3mla24.kept_weight,
                                                    ctx))


def _hidden(seed=1, tokens=BATCH * SEQ, width=256):
    """A token-major float32 residual stream of unit-normal values."""
    g = torch.Generator().manual_seed(seed)
    return torch.randn((tokens, width), generator=g)


def _rel(got, ref):
    return float((got - ref).norm() / ref.norm())


def _normed(h):
    return REF.rms_norm(h, torch.ones(h.shape[1]), 1e-6)


def test_the_config_reads_deepseeks_keys(small):
    cfg = small.cfg
    assert cfg.moe_layer_freq == (0, 0, 1, 1, 1)
    assert (cfg.n_group, cfg.topk_group, cfg.routed_scaling_factor,
            cfg.n_shared_experts) == (4, 2, 2.5, 1)
    assert (cfg.q_lora_rank, cfg.kv_lora_rank, cfg.layernorm_epsilon) == (
        1536, 512, 1e-6)
    assert dict(cfg.rope_scaling)["factor"] == 40
    assert cfg.n_routed_experts == 32 and cfg.held_experts == (0, 1, 2, 3)
    attn, ffn = small.params.layers[2]
    assert isinstance(attn, mla.Mla) and attn.heads == 2
    assert isinstance(ffn, mt.Moe) and ffn.shared is not None
    assert ffn.shared[0].shape == (2 * 128, 256)
    assert isinstance(small.params.layers[1][1], mt.DenseFfn)
    assert attn.kv_a.shape == (512 + 64, 256)
    assert attn.kv_b.shape == (2 * (128 + 128), 512)


def test_yarn_frequencies_and_scale_against_values_worked_by_hand():
    """DeepSeek-V3's published RoPE (64 rope dims, base 1e4, YaRN factor
    40 over 4096 positions, beta_fast 32, beta_slow 1): the correction
    range is dims 10..23 (64 ln(4096 / 64 pi) / 2 ln 1e4 = 10.47 floored,
    64 ln(4096 / 2 pi) / 2 ln 1e4 = 22.51 ceiled); below it the base
    frequencies 10 ** (-j / 8), above it those over 40, between them the
    ramp (j - 10) / 13 (at j = 16: 0.01 * 7/13 + 0.00025 * 6/13 = 0.0055).
    The softmax scale is 192 ** -0.5 * (1 + 0.1 ln 40) ** 2 = 0.1352337."""
    cfg = mt.MoeTransformerConfig.from_dict(
        CONFIG, held_experts=(0,), moe_layer_freq=(1,),
        layernorm_epsilon=1e-6)
    scaling = dict(cfg.rope_scaling)
    got = mla.yarn_inv_freq(64, 1e4, scaling)
    want = {0: 1.0, 9: 10 ** -1.125, 10: 10 ** -1.25, 16: 0.0055,
            23: 10 ** -2.875 / 40, 31: 10 ** -3.875 / 40}
    for j, value in want.items():
        assert math.isclose(float(got[j]), value, rel_tol=1e-12), j
    ref = REF.yarn_frequencies(CONFIG)
    assert torch.allclose(ref, got, rtol=1e-12, atol=0)
    assert math.isclose(mla.softmax_scale(cfg), 0.1352337, rel_tol=1e-6)
    assert math.isclose(REF.softmax_scale(CONFIG), 0.1352337, rel_tol=1e-6)
    plain = mla.yarn_inv_freq(64, 1e4, None)
    assert float(plain[16]) == pytest.approx(0.01)


def test_rope_turns_interleaved_pairs():
    """Each pair (2j, 2j + 1) turns as one complex number by its angle;
    the rotate-half pairs (j, j + r) do not."""
    g = torch.Generator().manual_seed(3)
    y = torch.randn((2, 5, 8), generator=g)
    ang = torch.rand((5, 4), generator=g) * 6
    got = mla.rope_pairs(y.clone(), ang.cos(), ang.sin())
    z = torch.view_as_complex(y.view(2, 5, 4, 2).contiguous())
    want = torch.view_as_real(z * torch.polar(torch.ones_like(ang), ang))
    assert torch.allclose(got, want.flatten(-2), atol=1e-6)
    half = faults_dsv3._rotate_half(y.clone(), ang.cos(), ang.sin())
    assert (half - got).abs().max() > 0.1


@pytest.mark.parametrize("layer", [0, 3], ids=["dense", "moe"])
def test_mla_block_matches_the_reference(small, layer):
    h = _hidden(2 + layer)
    attn = small.params.layers[layer][0]
    got = mla.mla_attention(attn, h.T.contiguous(), small.cfg, BATCH) - h.T
    want = REF.attention(_normed(h), small.spec, layer, small.weight, BATCH)
    assert _rel(got, want.T) < TOL


def test_rotate_half_or_no_mscale_in_place_departs_from_the_reference(small):
    h = _hidden(4)
    attn = small.params.layers[0][0]
    want = REF.attention(_normed(h), small.spec, 0, small.weight, BATCH)
    for fault in ("rotate_half", "mscale_left_out"):
        with faults_dsv3.planted(fault):
            got = mla.mla_attention(attn, h.T.contiguous(), small.cfg,
                                    BATCH) - h.T
        assert _rel(got, want.T) > 3 * TOL, fault


def test_the_mla_record_and_its_products(small):
    attn = small.params.layers[0][0]
    entered = []
    trace.reset()
    with trace.recording():
        mla.mla_attention(attn, _hidden(5).T.contiguous(), small.cfg, BATCH,
                          lambda: _Entered(entered))
    spans = trace.summary()["spans"]
    trace.reset()
    assert spans["sparsifyme.mla"]["count"] == 1
    for phase in ("q_latent", "kv_latent", "rope", "core", "out"):
        assert spans["sparsifyme.mla." + phase]["count"] == 1
    assert entered == [2, 2, 1]  # q_a, kv_a; q_b, kv_b; o
    assert spans["sparsifyme.spmm_24"]["count"] == 5


class _Entered:
    """A ``products()`` context that counts the 2:4 calls inside it."""

    def __init__(self, log):
        self.log = log

    def __enter__(self):
        self.calls = trace.summary()["spans"].get(
            "sparsifyme.spmm_24", {}).get("count", 0)

    def __exit__(self, *exc):
        now = trace.summary()["spans"]["sparsifyme.spmm_24"]["count"]
        self.log.append(now - self.calls)


def _route(small, layer, seed):
    moe = small.params.layers[layer][1]
    h = _hidden(seed).T.contiguous()
    x, d = mt.moe_route(moe, h, small.cfg)
    return moe, h, x, d


def test_no_choice_comes_from_a_masked_group(small):
    """Every token's choices lie in its 2 kept groups of 4, which are the
    groups of highest top-2 sum of score + bias, and are the top-4 of score
    + bias within them; the reference's group-limited choice agrees on all
    but the rare near-tie."""
    moe, h, x, d = _route(small, 2, 7)
    scores = mt.product_f32(x, moe.router.T).sigmoid_()
    biased = scores + moe.bias
    by_group = biased.view(-1, 4, 8)
    kept = by_group.topk(2, -1).values.sum(-1).topk(2, -1).indices
    groups = d.selected // 8
    assert bool((groups[..., None] == kept[:, None, :]).any(-1).all())
    masked, keep = mt.group_limit(biased, 4, 2)
    assert torch.equal(keep.sum(-1), torch.full((h.shape[1],), 2))
    assert bool(torch.isinf(masked[~keep.repeat_interleave(8, 1)]).all())
    assert torch.equal(d.selected, masked.topk(4, -1).indices)
    free = biased.topk(4, -1).indices
    assert not torch.equal(free.sort(-1).values, d.selected.sort(-1).values)
    sel, _ = REF.route(_normed(h.T), small.spec, 2, small.weight)
    same = (sel.sort(-1).values == d.selected.sort(-1).values).all(-1)
    assert int((~same).sum()) <= 2


def test_the_weights_carry_the_routed_scale(small):
    """Each held (token, choice) row's weight is its score over the sum of
    the token's four chosen scores, times 2.5; the group count is the
    tokens whose kept groups include group 0, the held experts'."""
    moe, h, x, d = _route(small, 3, 8)
    scores = mt.product_f32(x, moe.router.T).sigmoid_()
    w = scores.gather(1, d.selected)
    w = w / w.sum(-1, keepdim=True) * 2.5
    held = d.slot >= 0
    assert torch.equal(d.weight[d.slot[held].long()], w[held])
    assert float(w.sum(-1).mean()) == pytest.approx(2.5)
    trace.reset()
    with trace.recording():
        _, d = mt.moe_route(moe, h, small.cfg)
        mt.moe_combine(h, d, mt.moe_experts(moe, x, d))
    counters = trace.summary()["counters"]
    trace.reset()
    _, keep = mt.group_limit(scores + moe.bias, 4, 2)
    assert counters["moe.group_tokens"] == int(keep[:, 0].sum())
    assert 0 < counters["moe.group_tokens"] < h.shape[1]


def test_the_shared_expert_runs_on_every_token(small):
    moe, h, x, d = _route(small, 4, 9)
    assert d.normed is not None and d.normed.shape == h.shape
    trace.reset()
    with trace.recording():
        got = mt.moe_shared(moe, h, d) - h
    summary = trace.summary()
    trace.reset()
    assert d.normed is None  # dropped once taken
    assert summary["counters"]["moe.shared_rows"] == h.shape[1]
    assert summary["spans"]["sparsifyme.spmm_24"]["count"] == 2
    want = REF.shared_expert(_normed(h.T), small.spec, 4, small.weight)
    assert _rel(got, want.T) < TOL


@pytest.mark.parametrize("layer", [2, 4])
def test_moe_layer_matches_the_reference_where_the_choice_agrees(small,
                                                                 layer):
    moe, h, x, d = _route(small, layer, 10 + layer)
    got = mt.moe_combine(mt.moe_shared(moe, h, d), d,
                         mt.moe_experts(moe, x, d)) - h
    xr = _normed(h.T)
    sel, _ = REF.route(xr, small.spec, layer, small.weight)
    same = (d.selected.sort(-1).values == sel.sort(-1).values).all(-1)
    assert int((~same).sum()) <= 2
    want = REF.moe(xr, small.spec, layer, small.weight)
    assert _rel(got.T[same], want[same]) < TOL
    held = torch.tensor(small.spec["held_experts"])
    assert sum(d.rows) == int((d.selected[..., None] == held).sum()) > 0


def test_the_whole_forward_matches_the_reference(small):
    """Both outputs within 2e-2 of a reference forward that takes the
    program's choices (each layer's bf16 rounding, 3-6e-3); the choices
    are the reference's own on nearly every token."""
    route = dsv3mla24.Dsv3Mla24()
    got = route.run_pass((small.params, small.ids, small.cfg), False)
    choices = [sel for _, _, sel in route._moe]
    want = REF.forward(small.ids, small.spec, small.weight, choices=choices)
    assert got[0].shape == want[0].shape == (256, BATCH * SEQ)
    assert got[1].shape == want[1].shape == (BATCH, 512)
    assert reference.readings(got[0], want[0])[0] < 2e-2
    assert reference.readings(got[1], want[1])[0] < 2e-2
    for (before, _, sel), layer in zip(route._moe, (2, 3, 4)):
        _, biased = REF.router_scores(_normed(before.T), small.spec, layer,
                                      small.weight)
        assert float((REF.violation(biased, sel, small.spec) > 0)
                     .float().mean()) < 0.05


def test_a_pass_norms_its_latents_as_they_are(small, monkeypatch):
    """DeepSeek-V3's forward: three norms in each MLA block (the input in
    float32, the q and kv latents in bf16, with no float32 copy), one in
    the dense FFN or the router, the final one (45 at the cell's 11
    layers); the router asks for both layouts (the shared expert reads the
    feature-major one), every other norm for the feature-major one."""
    calls, real = [], mt.rms_norm_layouts

    def spy(h, w, eps, feature, token):
        calls.append((h.dtype, h.shape[0], feature, token))
        return real(h, w, eps, feature, token)
    monkeypatch.setattr(mt, "rms_norm_layouts", spy)
    mt.forward(small.params, small.ids, small.cfg)
    layers = len(small.params.layers)
    moe = sum(isinstance(f, mt.Moe) for _, f in small.params.layers)
    assert len(calls) == 4 * layers + 1
    assert calls.count((torch.bfloat16, 1536, True, False)) == layers
    assert calls.count((torch.bfloat16, 512, True, False)) == layers
    assert calls.count((torch.float32, 256, True, True)) == moe
    assert calls.count((torch.float32, 256, True, False)) == \
        2 * layers + 1 - moe


def test_the_routes_pass_is_the_models_forward(small):
    """The route's pass gives the model's two outputs, then what each of
    the 3 MoE layers added to the residual stream."""
    route = dsv3mla24.Dsv3Mla24()
    state = (small.params, small.ids, small.cfg)
    got = route.run_pass(state, False)
    want = mt.forward(small.params, small.ids, small.cfg)
    assert len(got) == route.outputs(small.ctx, []) == 2 + 3
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    for delta, (before, after, sel) in zip(got[2:], route._moe):
        assert torch.equal(delta[5:9], after[5:9] - before[5:9])
        assert sel.shape == (BATCH * SEQ, 4)
    designs = dict(d.split() for d in route.designs(state))
    assert designs["kv_a"] == "mma_sp"  # 576 rows: not a multiple of 128
    assert designs["o"] == designs["shared.gate_up"] == "wgmma_sp"


def test_the_routes_references_follow_near_ties_only(small):
    """Each MoE layer's reference takes the program's choice only within
    ``TIE``: every layer reads within 1e-2 and its control outside; a
    choice moved into a masked group departs."""
    route = dsv3mla24.Dsv3Mla24()
    got = route.run_pass((small.params, small.ids, small.cfg), False)
    before, _, sel = route._moe[0]
    for i in range(2, len(got)):
        ref, ctl = route.reference(small.ctx, [], i, True)
        assert reference.readings(got[i], ref)[0] < TOL
        assert reference.readings(ctl, ref)[0] > TOL
    assert route._moe is None
    x = _normed(before.T)
    _, biased = REF.router_scores(x, small.spec, 2, small.weight)
    assert float(REF.violation(biased, sel, small.spec).max()) <= \
        dsv3mla24.TIE
    groups = REF.group_scores(biased, small.spec)
    worst = int(groups[0].argmin())
    moved = sel.clone()
    moved[0, 0] = 8 * worst + int(biased[0, 8 * worst:8 * worst + 8]
                                  .argmax())
    assert float(REF.violation(biased, moved, small.spec)[0]) > \
        dsv3mla24.TIE
    spread = sel.clone()
    spread[0] = torch.arange(4) * 8  # one expert in each of 4 groups
    assert math.isinf(float(REF.violation(biased, spread, small.spec)[0]))


# the shares test: 8 heads and 32 experts, 4 cards of 2 heads and 8
# experts each (group 0, 1, 2 and 3 of the router's 4); the shared expert
# is every card's, counted once
SHARES = 4
WHOLE = dict(SMALL, num_hidden_layers=3, num_attention_heads=8,
             num_key_value_heads=8, n_routed_experts=32)
SHARE = dict(WHOLE, num_attention_heads=2, num_key_value_heads=2,
             n_routed_experts=8)


def _share_weight(full, j, name, shape):
    """Share j's part of the whole model's weight ``name``: its 2 heads'
    rows of q_b and kv_b and columns of o."""
    layer, part = name.split(".", 1) if "." in name else (None, name)
    per = {"q_b": 192, "kv_b": 256, "o": 128}.get(part)
    if per is None:
        return full(name, shape)
    if part == "o":
        return full(name, (256, 8 * per))[:, 2 * j * per:(2 * j + 2) * per]
    rows = full(name, (8 * per, shape[1]))
    return rows[2 * j * per:(2 * j + 2) * per]


def test_the_shares_of_four_cards_add_up_to_the_uncut_layer():
    ctx = _ctx(WHOLE, SEED + 1)
    full = functools.partial(dsv3mla24.weight, ctx)
    kept = functools.partial(dsv3mla24.kept_weight, ctx)
    h = _hidden(21)
    x = _normed(h)
    whole = dsv3mla24.MIMO.ref_spec(WHOLE)
    layer = 2
    want_attn = REF.attention(x, whole, layer, kept, BATCH)
    want_moe = REF.moe(x, whole, layer, kept)
    sel, _ = REF.route(x, whole, layer, kept)
    ref_attn, ref_routed = torch.zeros_like(h), torch.zeros_like(h)
    port_attn, port_moe = torch.zeros_like(h.T), torch.zeros_like(h.T)
    same = torch.ones(h.shape[0], dtype=torch.bool)
    shared = None
    for j in range(SHARES):
        held = list(range(8 * j, 8 * j + 8))
        spec = dict(dsv3mla24.MIMO.ref_spec(SHARE), held_experts=held)
        wj = functools.partial(_share_weight, kept, j)
        ref_attn += REF.attention(x, spec, layer, wj, BATCH)
        ref_routed += REF.routed(x, spec, layer, kept)
        cfg = dataclasses.replace(dsv3mla24.model_config(SHARE),
                                  held_experts=tuple(held))
        params = mt.init_params(cfg, functools.partial(_share_weight, full,
                                                       j))
        attn, moe = params.layers[layer]
        port_attn += mla.mla_attention(attn, h.T.contiguous(), cfg,
                                       BATCH) - h.T
        ht = h.T.contiguous()
        xs, d = mt.moe_route(moe, ht, cfg)
        if shared is None:  # every card computes it; counted once
            shared = mt.moe_shared(moe, ht, d) - ht
        d.normed = None
        port_moe += mt.moe_combine(ht, d, mt.moe_experts(moe, xs, d)) - ht
        same &= (d.selected.sort(-1).values == sel.sort(-1).values).all(-1)
    ref_moe = ref_routed + REF.shared_expert(x, whole, layer, kept)
    assert _rel(ref_attn, want_attn) < 1e-5
    assert _rel(ref_moe, want_moe) < 1e-5
    assert _rel(port_attn, want_attn.T) < TOL
    assert int((~same).sum()) <= 2
    assert _rel((port_moe + shared).T[same], want_moe[same]) < TOL
