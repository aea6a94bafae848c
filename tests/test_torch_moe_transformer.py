"""MiMo-V2-Flash's block on the port (``models/moe_transformer.py``)
against the benchmark's plain float32 reference
(``perfbench/model_refs/mimo.py``), on the CPU at a small size: hidden
256, 4 held of 16 experts, top-4, 4 of 8 heads, window 16, the source's
first 7 layers' pattern, 2 sequences of 64 tokens. Weights come from the
benchmark route's seeded generator (``perfbench/model_routes/mimo24.py``),
2:4-kept for the reference by ``reference.keep_24``.

Tolerances: a block's products take bf16 operands and give bf16 results
(about 2**-9 relative each), so one block reads 3-5e-3 against the float32
reference; 1e-2 holds each block with room. A MoE layer compares the
tokens whose top-4 choice is the reference's: a choice flips where the
4th and 5th scores lie within the rounding of the bf16 input, and a flipped
token's share is another expert's.
"""

import dataclasses
import functools
from types import SimpleNamespace

import pytest
import torch

from perfbench import reference
from perfbench.model_routes import mimo24
from sparsifyme_tpu_torch.models import moe_transformer as mt
from sparsifyme_tpu_torch.utils import trace

REF = mimo24.REF
SEED = 2 ** 31 + 11
BATCH, SEQ = 2, 64
SMALL = {
    "hidden_size": 256, "intermediate_size": 512,
    "moe_intermediate_size": 128, "vocab_size": 512,
    "num_hidden_layers": 7, "hybrid_layer_pattern": [0, 1, 1, 1, 1, 0, 1],
    "moe_layer_freq": [0, 1, 1, 1, 1, 1, 1], "head_dim": 48,
    "v_head_dim": 32, "swa_head_dim": 48, "swa_v_head_dim": 32,
    "num_attention_heads": 4, "num_key_value_heads": 1,
    "swa_num_attention_heads": 4, "swa_num_key_value_heads": 1,
    "n_routed_experts": 4, "num_experts_per_tok": 4, "norm_topk_prob": True,
    "sliding_window": 16, "add_swa_attention_sink_bias": True,
    "add_full_attention_sink_bias": False, "partial_rotary_factor": 0.334,
    "rope_theta": 5e6, "swa_rope_theta": 1e4, "attention_value_scale": 0.707,
    "layernorm_epsilon": 1e-5, "published": {"n_routed_experts": 16}}
TOL = 1e-2


def _ctx(config=SMALL, seed=SEED):
    return SimpleNamespace(device=torch.device("cpu"), seed=seed,
                           config=config, rank=0,
                           traffic={"sequences": BATCH, "seq_len": SEQ})


@pytest.fixture(scope="module")
def small():
    ctx = _ctx()
    params, ids, cfg = mimo24.Mimo24().setup(ctx, [])
    return SimpleNamespace(ctx=ctx, params=params, ids=ids, cfg=cfg,
                           spec=mimo24.ref_spec(SMALL),
                           weight=functools.partial(mimo24.kept_weight, ctx))


def _hidden(seed=1, tokens=BATCH * SEQ, width=256):
    """A token-major float32 residual stream of unit-normal values."""
    g = torch.Generator().manual_seed(seed)
    return torch.randn((tokens, width), generator=g)


def _rel(got, ref):
    return float((got - ref).norm() / ref.norm())


@pytest.mark.parametrize("layer", [0, 1], ids=["full", "window"])
def test_attention_block_matches_the_reference(small, layer):
    h = _hidden()
    attn = small.params.layers[layer][0]
    assert bool(attn.window) == bool(layer) and (attn.sinks is None) == (
        layer == 0)
    got = mt.attention(attn, h.T.contiguous(), small.cfg, BATCH) - h.T
    x = REF.rms_norm(h, torch.ones(256), 1e-5)
    want = REF.attention(x, small.spec, layer, small.weight, BATCH)
    assert _rel(got, want.T) < TOL


def test_dense_ffn_matches_the_reference(small):
    h = _hidden(2)
    got = mt.dense_ffn(small.params.layers[0][1], h.T.contiguous(),
                       small.cfg) - h.T
    x = REF.rms_norm(h, torch.ones(256), 1e-5)
    assert _rel(got, REF.dense_ffn(x, small.spec, 0, small.weight).T) < TOL


def _moe(moe, h, cfg):
    x, d = mt.moe_route(moe, h.T.contiguous(), cfg)
    y = mt.moe_experts(moe, x, d)
    return mt.moe_combine(h.T.contiguous(), d, y) - h.T, d


@pytest.mark.parametrize("layer", [1, 6])
def test_moe_layer_matches_the_reference_where_the_choice_agrees(small,
                                                                 layer):
    h = _hidden(3 + layer)
    moe = small.params.layers[layer][1]
    got, d = _moe(moe, h, small.cfg)
    x = REF.rms_norm(h, torch.ones(256), 1e-5)
    sel, _ = REF.route(x, small.spec, layer, small.weight)
    same = (d.selected.sort(-1).values == sel.sort(-1).values).all(-1)
    assert int((~same).sum()) <= 2  # of 128 tokens
    want = REF.moe(x, small.spec, layer, small.weight)
    assert _rel(got.T[same], want[same]) < TOL
    held = torch.tensor(small.spec["held_experts"])
    assert sum(d.rows) == int((d.selected[..., None] == held).sum())


def test_groups_are_padded_to_64_rows_and_counted(small):
    moe = small.params.layers[2][1]
    h = _hidden(9)
    trace.reset()
    with trace.recording():
        x, d = mt.moe_route(moe, h.T.contiguous(), small.cfg)
        y = mt.moe_experts(moe, x, d)
        mt.moe_combine(h.T.contiguous(), d, y)
    got = trace.summary()
    trace.reset()
    start = 0
    for (s0, s1), rows in zip(d.bounds, d.rows):
        assert s0 == start and (s1 - s0) % mt.PAD_ROWS == 0
        assert rows <= s1 - s0 < rows + mt.PAD_ROWS
        assert bool((d.weight[s0:s0 + rows] > 0).all())
        assert bool((d.weight[s0 + rows:s1] == 0).all())
        assert bool((d.index[s0 + rows:s1] == 0).all())
        tokens = d.index[s0:s0 + rows]
        assert bool((tokens[1:] > tokens[:-1]).all())  # token order
        start = s1
    assert y.shape == (start, 256)  # token-major rows
    assert got["counters"]["moe.rows"] == sum(d.rows)
    assert got["counters"]["moe.pad_rows"] == start - sum(d.rows)
    spans = got["spans"]
    assert spans["sparsifyme.moe"]["count"] == 1
    for phase in ("router", "select", "dispatch", "experts", "combine"):
        assert spans["sparsifyme.moe." + phase]["count"] == 1
    assert spans["sparsifyme.spmm_24"]["count"] == 2 * sum(
        r > 0 for r in d.rows)


def test_an_expert_that_receives_no_token(small):
    """Held expert 1's correction bias far below every score: no token
    chooses it, its group is empty and its products are not called."""
    moe = small.params.layers[1][1]
    bias = moe.bias.clone()
    bias[small.spec["held_experts"][1]] = -100.0
    moe = dataclasses.replace(moe, bias=bias)
    h = _hidden(11)
    trace.reset()
    with trace.recording():
        got, d = _moe(moe, h, small.cfg)
    calls = trace.summary()["spans"]["sparsifyme.spmm_24"]["count"]
    trace.reset()
    assert d.rows[1] == 0 and d.bounds[1][0] == d.bounds[1][1]
    assert calls == 2 * sum(r > 0 for r in d.rows)

    def weight(name, shape):
        w = small.weight(name, shape)
        return bias if name == "1.router_bias" else w

    x = REF.rms_norm(h, torch.ones(256), 1e-5)
    sel, _ = REF.route(x, small.spec, 1, weight)
    same = (d.selected.sort(-1).values == sel.sort(-1).values).all(-1)
    want = REF.moe(x, small.spec, 1, weight)
    assert _rel(got.T[same], want[same]) < TOL


def _routed(small, layer, seed, empty=None):
    """Layer ``layer``'s MoE on a hidden state of ``seed``: ``(moe, h
    [hidden, tokens], x, d, y)``; held expert ``empty`` biased below every
    score, so that no token chooses it."""
    moe = small.params.layers[layer][1]
    if empty is not None:
        bias = moe.bias.clone()
        bias[small.spec["held_experts"][empty]] = -100.0
        moe = dataclasses.replace(moe, bias=bias)
    h = _hidden(seed).T.contiguous()
    x, d = mt.moe_route(moe, h, small.cfg)
    return moe, h, x, d, mt.moe_experts(moe, x, d)


@pytest.mark.parametrize("layer,empty", [(1, None), (6, None), (2, 1)],
                         ids=["layer1", "layer6", "empty_group"])
def test_the_slot_map_names_each_held_choice_row(small, layer, empty):
    """``Dispatch.slot`` is the inverse of ``index``: each held (token,
    choice) names a real row of its expert's group whose token is that
    token and whose weight is that choice's routing weight; -1 exactly
    where another card holds the expert; every real row named once, no
    padding row."""
    moe, h, x, d, _ = _routed(small, layer, 21 + layer, empty)
    tokens, top = d.selected.shape
    assert d.slot.shape == (tokens, top) and d.slot.dtype == torch.int32
    local = moe.local[d.selected]
    held = local >= 0
    assert torch.equal(d.slot >= 0, held)
    rows = d.slot[held].long()
    token = torch.arange(tokens)[:, None].expand(tokens, top)[held]
    assert torch.equal(d.index[rows], token)
    scores = mt.product_f32(x, moe.router.T).sigmoid_()
    w = scores.gather(1, d.selected)
    w = w / w.sum(-1, keepdim=True)
    assert torch.equal(d.weight[rows], w[held])
    real = torch.cat([torch.arange(s0, s0 + n)
                      for (s0, _), n in zip(d.bounds, d.rows)])
    assert torch.equal(rows.sort().values, real)
    starts = torch.tensor([s0 for s0, _ in d.bounds])
    ends = starts + torch.tensor(d.rows)
    assert bool(((rows >= starts[local[held]])
                 & (rows < ends[local[held]])).all())
    if empty is not None:
        assert d.rows[empty] == 0
    assert {0, 1, 2} <= set(held.sum(1).clamp(max=2).tolist())


def _combine_by_slot(h, d, y):
    """The combine kernel's arithmetic on the CPU: each token's held rows
    times their weights, each product rounded, summed from zero in choice
    order, then added to ``h``."""
    acc = torch.zeros(h.shape[1], h.shape[0])
    for j in range(d.slot.shape[1]):
        s = d.slot[:, j].long()
        on = s >= 0
        acc[on] += y[s[on]].float() * d.weight[s[on], None]
    return h + acc.T


@pytest.mark.parametrize("layer,empty", [(1, None), (2, 1)],
                         ids=["layer1", "empty_group"])
def test_the_plain_combine_is_the_scatter_of_weighted_rows(small, layer,
                                                          empty):
    """On the CPU ``moe_combine`` is the scatter formula bit for bit (an f32
    accumulator, ``index_add_`` of ``y * weight``, its transpose added), in
    a new tensor, with no kernel launch; the sum through the slot map in
    choice order, the kernel's arithmetic, gives the same bits on tokens
    with at most one held choice and agrees within 1e-6 elsewhere."""
    from sparsifyme_tpu_torch.ops.kernels import moe_kernel

    _, h, _, d, y = _routed(small, layer, 31 + layer, empty)
    keep, launches = h.clone(), moe_kernel.moe_combine_cuda.launches
    trace.reset()
    with trace.recording():
        got = mt.moe_combine(h, d, y)
    counters = trace.summary()["counters"]
    trace.reset()
    acc = h.new_zeros((h.shape[1], h.shape[0]))
    acc.index_add_(0, d.index, y * d.weight[:, None])
    assert torch.equal(got, h + acc.T)
    assert torch.equal(h, keep) and got.data_ptr() != h.data_ptr()
    assert "moe.combine_kernel" not in counters
    assert moe_kernel.moe_combine_cuda.launches == launches
    by_slot = _combine_by_slot(h, d, y)
    one = (d.slot >= 0).sum(1) <= 1
    assert torch.equal(by_slot[:, one], got[:, one])
    assert float((by_slot - got).abs().max() / got.abs().max()) <= 1e-6


def test_the_combine_kernel_needs_a_card():
    """The kernel's wrapper refuses CPU tensors (``moe_combine`` takes the
    plain version there)."""
    from sparsifyme_tpu_torch.ops.kernels import moe_kernel

    h = torch.zeros(8, 4)
    with pytest.raises(ValueError, match="CUDA"):
        moe_kernel.moe_combine_cuda(h, torch.zeros(4, 2, dtype=torch.int32),
                                    torch.zeros(0), torch.zeros(0, 8))


def _four_ops(h, w, eps):
    """The model's RMSNorm before the norm kernel: a float32 norm, two
    float32 multiplies and the cast."""
    ms = torch.linalg.vector_norm(h, dim=0, keepdim=True).square_().div_(
        h.shape[0])
    return (h * ms.add_(eps).rsqrt_()).mul_(w.float()[:, None]).to(
        torch.bfloat16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("feature,token", [(True, False), (False, True),
                                           (True, True)],
                         ids=["feature", "token", "both"])
def test_the_plain_norm_is_the_four_float32_ops(dtype, feature, token):
    """On the CPU every layout is the four float32 ops bit for bit (a bf16
    latent taken to float32 first, as the callers did), the token-major
    one their transpose, contiguous; no launch and no ``norm.kernel``
    count; ``rms_norm`` is the feature-major layout."""
    from sparsifyme_tpu_torch.ops.kernels import norm_kernel

    g = torch.Generator().manual_seed(5)
    h = (torch.randn((264, 100), generator=g) * 3).to(dtype)
    w = (1 + 0.2 * torch.randn(264, generator=g)).to(torch.bfloat16)
    want = _four_ops(h.float(), w, 1e-6)
    keep, launches = h.clone(), norm_kernel.rms_norm_cuda.launches
    trace.reset()
    with trace.recording():
        x, x_t = mt.rms_norm_layouts(h, w, 1e-6, feature, token)
    counters = trace.summary()["counters"]
    trace.reset()
    assert "norm.kernel" not in counters
    assert norm_kernel.rms_norm_cuda.launches == launches
    assert torch.equal(h, keep)
    assert (x is None) != feature and (x_t is None) != token
    if feature:
        assert x.dtype == torch.bfloat16 and torch.equal(x, want)
    if token:
        assert x_t.is_contiguous() and torch.equal(x_t, want.T)
    assert torch.equal(mt.rms_norm(h, w, 1e-6), want)


@pytest.mark.parametrize("hidden,itemsize,token,plan", [
    (4096, 4, False, (8, 512)), (4096, 4, True, (8, 512)),
    (7168, 4, False, (13, 576)), (7168, 4, True, (14, 512)),
    (1536, 2, False, (6, 256)), (512, 2, False, (2, 256)),
    (7168, 2, True, (16, 448)), (2056, 4, False, (7, 320)),
    (8, 4, False, (1, 64)), (9216, 4, False, (16, 576))])
def test_the_norm_plan_covers_hidden(hidden, itemsize, token, plan):
    """``norm_plan``: blocks of a multiple of 64 rows, as few a cluster as
    cover ``hidden`` once 8 would take more rows than a block's shared
    memory holds (its 128 bytes a row and, for out_t, two tiles, within
    75 KB, so that three share an SM), the rows spread evenly; one block
    fewer would not cover ``hidden``."""
    from sparsifyme_tpu_torch.ops.kernels import norm_kernel

    cluster, rows = norm_kernel.norm_plan(hidden, itemsize, token)
    assert (cluster, rows) == plan
    assert rows % 64 == 0 and cluster <= norm_kernel.MAX_CLUSTER
    tiles = 2 * 64 * (128 // itemsize) * 2 if token else 0
    assert 128 * rows + tiles <= norm_kernel.BLOCK_BYTES
    assert (cluster - 1) * rows < hidden <= cluster * rows


def test_the_norm_kernel_refuses_what_no_plan_holds():
    """Past 16 blocks of the most rows a block holds no cluster holds the
    hidden size (8192 with out_t in float32, 9216 without), and the
    kernel's wrapper refuses CPU tensors (the model takes the plain version
    there)."""
    from sparsifyme_tpu_torch.ops.kernels import norm_kernel

    assert norm_kernel.norm_plan(8192, 4, True) == (16, 512)
    with pytest.raises(ValueError, match="8192"):
        norm_kernel.norm_plan(8200, 4, True)
    with pytest.raises(ValueError, match="9216"):
        norm_kernel.norm_plan(9224, 4, False)
    h, w = torch.zeros(8, 4), torch.ones(8, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        norm_kernel.rms_norm_cuda(h, w, 1e-6, torch.empty(
            8, 4, dtype=torch.bfloat16))


def _norm_calls(monkeypatch):
    """Record each norm's (input dtype, hidden, feature, token)."""
    calls, real = [], mt.rms_norm_layouts

    def spy(h, w, eps, feature, token):
        calls.append((h.dtype, h.shape[0], feature, token))
        return real(h, w, eps, feature, token)
    monkeypatch.setattr(mt, "rms_norm_layouts", spy)
    return calls


def test_a_pass_norms_twice_a_layer_and_once_more(small, monkeypatch):
    """MiMo's forward: one norm in each attention block, one in the dense
    FFN or the router, the final one (27 at the cell's 13 layers); the
    router asks for the token-major layout alone (no shared expert reads
    the feature-major one), every other norm for the feature-major one."""
    calls = _norm_calls(monkeypatch)
    mt.forward(small.params, small.ids, small.cfg)
    layers = len(small.params.layers)
    moe = sum(isinstance(f, mt.Moe) for _, f in small.params.layers)
    assert len(calls) == 2 * layers + 1
    assert calls.count((torch.float32, 256, False, True)) == moe
    assert calls.count((torch.float32, 256, True, False)) == \
        2 * layers + 1 - moe


def test_the_window_edge_and_the_sink():
    """Values one-hot by position: query i's output is its attention row.
    It reaches exactly keys i-15..i, and the sink takes exp(s) /
    (Z + exp(s)) of it; without a sink the row sums to 1."""
    g = torch.Generator().manual_seed(5)
    seq, window, d = 48, 16, 16
    q = torch.randn((1, 2, seq, d), generator=g).to(torch.bfloat16)
    k = torch.randn((1, 1, seq, d), generator=g).to(torch.bfloat16)
    v = torch.eye(seq, dtype=torch.bfloat16)[None, None]
    sinks = torch.tensor([0.5, -1.0])
    rows = mt.window_attention(q, k, v, sinks, window).float()[0]
    plain = mt.window_attention(q, k, v, None, window).float()[0]
    pos = torch.arange(seq)
    seen = (pos[None] <= pos[:, None]) & (pos[None] > pos[:, None] - window)
    assert bool((rows[:, ~seen] == 0).all())
    assert bool((rows[:, seen] > 0).all())
    assert torch.allclose(plain.sum(-1), torch.ones(2, seq), atol=1e-2)
    scores = (q.float() @ k.float().transpose(-1, -2))[0] * d ** -0.5
    scores = scores.masked_fill(~seen, float("-inf"))
    z = torch.exp(scores).sum(-1)
    share = z / (z + torch.exp(sinks)[:, None])
    assert torch.allclose(rows.sum(-1), share, atol=1e-2)
    want = torch.exp(scores) / (z + torch.exp(sinks)[:, None])[..., None]
    assert (rows - want).abs().max() < 1e-2


def test_the_whole_forward_matches_the_reference(small):
    """Both outputs within 2e-2: each block's bf16 rounding (3-5e-3), and
    the rare token whose choice flips in some layer."""
    hidden, logits = mt.forward(small.params, small.ids, small.cfg)
    ref_hidden, ref_logits = REF.forward(small.ids, small.spec,
                                         small.weight)
    assert hidden.shape == ref_hidden.shape == (256, BATCH * SEQ)
    assert logits.shape == ref_logits.shape == (BATCH, 512)
    assert reference.readings(hidden, ref_hidden)[0] < 2e-2
    assert reference.readings(logits, ref_logits)[0] < 2e-2


def test_the_routes_pass_is_the_models_forward(small):
    """The route's pass gives the model's two outputs, then what each of
    the 6 MoE layers added to the residual stream."""
    route = mimo24.Mimo24()
    state = (small.params, small.ids, small.cfg)
    got = route.run_pass(state, False)
    want = mt.forward(small.params, small.ids, small.cfg)
    assert len(got) == route.outputs(small.ctx, []) == 2 + 6
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    for delta, (before, after, sel) in zip(got[2:], route._moe):
        assert delta.shape == after.shape == (256, BATCH * SEQ)
        assert torch.equal(delta[5:9], after[5:9] - before[5:9])
        assert sel.shape == (BATCH * SEQ, 4)
    designs = dict(d.split() for d in route.designs(state))
    assert designs["o"] == designs["expert.gate_up"] == "wgmma_sp"
    assert designs["q"] == "mma_sp"  # 4 x 48 rows: not a multiple of 128


def test_the_routes_references_follow_near_ties_only(small):
    """Each MoE layer's reference is the reference's layer on the
    program's own input, taking the program's choice only within the
    route's margin: every layer reads within 1e-2; the same layer with
    the choice of one token moved to an expert far below its top-k
    departs from it."""
    route = mimo24.Mimo24()
    got = route.run_pass((small.params, small.ids, small.cfg), False)
    before, after, sel = route._moe[0]
    for i in range(2, len(got)):
        ref, ctl = route.reference(small.ctx, [], i, True)
        assert reference.readings(got[i], ref)[0] < TOL
        assert reference.readings(ctl, ref)[0] > TOL
    assert route._moe is None  # dropped after the last layer's
    x = REF.rms_norm(before.T, torch.ones(256), 1e-5)
    _, biased = REF.router_scores(x, small.spec, 1, small.weight)
    v = REF.violation(biased, sel)
    assert float(v.max()) <= mimo24.TIE
    moved = sel.clone()
    moved[0, 0] = int(biased[0].argmin())
    assert float(REF.violation(biased, moved)[0]) > mimo24.TIE
    follows = REF.moe(x, small.spec, 1, small.weight, prefer=sel,
                      tie=mimo24.TIE)
    other = REF.moe(x, small.spec, 1, small.weight, prefer=moved,
                    tie=mimo24.TIE)
    own = REF.moe(x, small.spec, 1, small.weight)
    assert torch.allclose(other[0], own[0], rtol=0, atol=1e-6)
    assert torch.allclose(other[1:], follows[1:], rtol=0, atol=1e-6)
    twice = sel.clone()
    twice[:, 1] = twice[:, 0]
    assert bool(torch.isinf(REF.violation(biased, twice)).all())


# the shares test: 16 heads and 16 experts, 8 cards of 2 heads and 2
# experts each; layer 0 full (2 KV heads, 8 q heads each), layer 1 window
# (4 KV heads, 4 q heads each), both MoE
SHARES = 8
WHOLE = dict(SMALL, num_hidden_layers=2, hybrid_layer_pattern=[0, 1],
             moe_layer_freq=[1, 1], num_attention_heads=16,
             num_key_value_heads=2, swa_num_attention_heads=16,
             swa_num_key_value_heads=4, n_routed_experts=16)


def _share_weight(full, j, name, shape):
    """Share j's part of the whole model's weight ``name``."""
    layer, part = name.split(".", 1) if "." in name else (None, name)
    if layer is None or part not in ("q", "k", "v", "o", "sinks"):
        return full(name, shape)
    heads, kv, dqk, dv = 16, (4 if int(layer) else 2), 48, 32
    h0, kvh = 2 * j, (2 * j) // (heads // kv)
    size = {"q": dqk, "k": dqk, "v": dv, "o": dv, "sinks": 1}[part]
    whole = full(name, {"q": (heads * dqk, 256), "k": (kv * dqk, 256),
                        "v": (kv * dv, 256), "o": (256, heads * dv),
                        "sinks": (heads,)}[part])
    if part == "o":
        return whole[:, h0 * dv:(h0 + 2) * dv]
    first = kvh if part in ("k", "v") else h0
    count = 1 if part in ("k", "v") else 2
    return whole[first * size:(first + count) * size]


def test_the_shares_of_eight_cards_add_up_to_the_whole_layer():
    ctx = _ctx(WHOLE, SEED + 1)
    full = functools.partial(mimo24.weight, ctx)
    kept = functools.partial(mimo24.kept_weight, ctx)
    h = _hidden(21)
    x = REF.rms_norm(h, torch.ones(256), 1e-5)
    whole = mimo24.ref_spec(WHOLE)
    for layer in (0, 1):
        want_attn = REF.attention(x, whole, layer, kept, BATCH)
        want_moe = REF.moe(x, whole, layer, kept)
        sel, _ = REF.route(x, whole, layer, kept)
        ref_attn = torch.zeros_like(h)
        ref_moe = torch.zeros_like(h)
        port_attn = torch.zeros_like(h.T)
        port_moe = torch.zeros_like(h.T)
        same = torch.ones(h.shape[0], dtype=torch.bool)
        for j in range(SHARES):
            held = [2 * j, 2 * j + 1]
            share = dict(WHOLE, num_attention_heads=2, num_key_value_heads=1,
                         swa_num_attention_heads=2, swa_num_key_value_heads=1,
                         n_routed_experts=2)
            spec = dict(mimo24.ref_spec(share), held_experts=held)
            ref_attn += REF.attention(
                x, spec, layer, functools.partial(_share_weight, kept, j),
                BATCH)
            ref_moe += REF.moe(x, spec, layer, kept)
            cfg = mt.MoeTransformerConfig.from_dict(
                share, n_routed_experts=16, held_experts=tuple(held))
            params = mt.init_params(
                cfg, functools.partial(_share_weight, full, j))
            attn, moe = params.layers[layer]
            port_attn += mt.attention(attn, h.T.contiguous(), cfg,
                                      BATCH) - h.T
            got, d = _moe(moe, h, cfg)
            port_moe += got
            same &= (d.selected.sort(-1).values == sel.sort(-1).values).all(-1)
        assert _rel(ref_attn, want_attn) < 1e-5
        assert _rel(ref_moe, want_moe) < 1e-5
        assert _rel(port_attn, want_attn.T) < TOL
        assert int((~same).sum()) <= 2
        assert _rel(port_moe.T[same], want_moe[same]) < TOL


def test_mimos_keys_select_the_router_without_group_or_scale(small,
                                                             monkeypatch):
    """MiMo's configuration file gives n_group 1, topk_group 1 and no
    routed scale or shared expert, which the port reads and which select
    today's path: the group limit is never called, the choice is the top-k
    of score + bias over every expert, the weights the chosen scores over
    their sum, no normed input is kept for a shared step and no group
    count is read."""
    import json
    from pathlib import Path

    config = json.loads((Path(__file__).resolve().parents[1] / "perfbench"
                         / "configs" / "mimo-v2-flash-ep8.json").read_text())
    cfg = mimo24.model_config(config)
    assert (cfg.n_group, cfg.topk_group, cfg.routed_scaling_factor,
            cfg.n_shared_experts, cfg.q_lora_rank) == (1, 1, None, None,
                                                       None)
    assert (small.cfg.n_group, small.cfg.routed_scaling_factor) == (1, None)
    moe = small.params.layers[3][1]
    assert moe.shared is None

    def refused(*args):
        raise AssertionError("MiMo's router took the group limit")

    monkeypatch.setattr(mt, "group_limit", refused)
    h = _hidden(12).T.contiguous()
    trace.reset()
    with trace.recording():
        x, d = mt.moe_route(moe, h, small.cfg)
        mt.moe_combine(h, d, mt.moe_experts(moe, x, d))
    counters = trace.summary()["counters"]
    trace.reset()
    assert "moe.group_tokens" not in counters
    assert "moe.shared_rows" not in counters
    assert d.normed is None
    scores = mt.product_f32(x, moe.router.T).sigmoid_()
    assert torch.equal(d.selected,
                       torch.topk(scores + moe.bias, 4, dim=-1).indices)
    w = scores.gather(1, d.selected)
    w = w / w.sum(-1, keepdim=True)
    held = d.slot >= 0
    assert torch.equal(d.weight[d.slot[held].long()], w[held])


def _mimo_file_without(key):
    import json
    from pathlib import Path

    config = json.loads((Path(__file__).resolve().parents[1] / "perfbench"
                         / "configs" / "mimo-v2-flash-ep8.json").read_text())
    del config[key]
    return mimo24.model_config(config)


@pytest.mark.parametrize("case", ["file_without_head_dim", "no_sink_flag",
                                  "pattern_short", "mla_without_widths"])
def test_a_config_missing_its_attention_keys_is_refused(small, case):
    """The attention kind that a configuration selects has to be whole: a
    GQA one (no ``q_lora_rank``) every key of ``GQA_FIELDS`` and a
    window pattern a layer, an MLA one its three widths; one left out
    raises instead of building a block of width 0."""
    cfg = small.cfg
    make, match = {
        "file_without_head_dim": (lambda: _mimo_file_without("head_dim"),
                                  "GQA attention needs head_dim"),
        "no_sink_flag": (lambda: dataclasses.replace(
            cfg, add_swa_attention_sink_bias=None),
            "needs add_swa_attention_sink_bias"),
        "pattern_short": (lambda: dataclasses.replace(
            cfg, hybrid_layer_pattern=cfg.hybrid_layer_pattern[:-1]),
            "different numbers of layers"),
        "mla_without_widths": (lambda: dataclasses.replace(
            cfg, q_lora_rank=8),
            "multi-head latent attention needs kv_lora_rank, "
            "qk_nope_head_dim, qk_rope_head_dim"),
    }[case]
    with pytest.raises(ValueError, match=match):
        make()
    assert dataclasses.replace(cfg) == cfg  # the whole one is taken


def test_full_attention_takes_the_callers_scale():
    """``full_attention`` scales the scores by the scale it is given (MLA
    passes YaRN's, GQA ``d ** -0.5``): causal softmax of q k^T * scale."""
    g = torch.Generator().manual_seed(13)
    q, k, v = (torch.randn((1, 2, 16, 8), generator=g).to(torch.bfloat16)
               for _ in range(3))
    seen = torch.ones(16, 16, dtype=torch.bool).tril()
    for scale in (8 ** -0.5, 0.9):
        got = mt.full_attention(q, k, v, scale).float()
        s = (q.float() @ k.float().transpose(-1, -2)) * scale
        want = torch.softmax(s.masked_fill(~seen, float("-inf")), -1) @ \
            v.float()
        assert (got - want).abs().max() < 2e-2
    assert (mt.full_attention(q, k, v, 0.9)
            - mt.full_attention(q, k, v, 0.1)).abs().max() > 0.1


# --- per-layer attention: Kimi Linear's KDA and NoPE MLA layers ------------

@pytest.fixture(scope="module")
def kimi():
    from perfbench.model_routes import kimilinear24
    from perfbench.tests.kimi_small import BATCH as KB, SEQ as KS, SMALL as KC

    ctx = SimpleNamespace(device=torch.device("cpu"), seed=2 ** 31 + 11,
                          config=KC, rank=0,
                          traffic={"sequences": KB, "seq_len": KS})
    params, ids, cfg = kimilinear24.KimiLinear24().setup(ctx, [])
    return SimpleNamespace(params=params, ids=ids, cfg=cfg, ctx=ctx,
                           route=kimilinear24,
                           spec=kimilinear24.ref_spec(KC),
                           weight=functools.partial(kimilinear24.kept_weight,
                                                    ctx))


def test_each_layer_takes_its_attention_kind(kimi, monkeypatch):
    """``linear_attn_config`` (1-indexed ``kda_layers``) selects KDA, the
    other layers MLA: ``init_params`` builds each layer's block and
    ``forward`` steps each through its own; a config whose lists miss or
    repeat a layer is refused."""
    from perfbench.tests.kimi_small import KDA_LAYERS, MLA_LAYERS
    from sparsifyme_tpu_torch.models import kda, mla

    cfg = kimi.cfg
    kinds = [cfg.attention_kind_of(i) for i in range(cfg.num_hidden_layers)]
    assert [i for i, k in enumerate(kinds) if k == "kda"] == KDA_LAYERS
    assert [i for i, k in enumerate(kinds) if k == "mla"] == MLA_LAYERS
    for i, (attn, _) in enumerate(kimi.params.layers):
        assert isinstance(attn, kda.Kda if i in KDA_LAYERS else mla.Mla), i
        assert mt.attention_kind(cfg, i)[1] is (
            kda.kda_attention if i in KDA_LAYERS else mla.mla_attention)
    steps = []

    def spy(name, fn):
        def step(p, h, config, batch, *rest):
            steps.append(name)
            return fn(p, h, config, batch, *rest)
        return step

    monkeypatch.setattr(kda, "kda_attention",
                        spy("kda", kda.kda_attention))
    monkeypatch.setattr(mla, "mla_attention",
                        spy("mla", mla.mla_attention))
    mt.forward(kimi.params, kimi.ids, cfg)
    assert steps == kinds
    lin = dict(cfg.linear_attn_config)
    with pytest.raises(ValueError, match="every layer once"):
        dataclasses.replace(cfg, linear_attn_config=tuple(
            dict(lin, kda_layers=lin["kda_layers"] + (3,)).items()))
    with pytest.raises(ValueError, match="needs head_dim"):
        dataclasses.replace(cfg, linear_attn_config=tuple(
            (k, v) for k, v in lin.items() if k != "head_dim"))


@pytest.mark.parametrize("model", ["mimo", "dsv3"])
def test_mimo_and_deepseek_keep_one_kind_in_every_layer(small, model):
    """MiMo's and DeepSeek-V3's configurations name no linear attention:
    every layer takes the kind the whole model took before (GQA, MLA),
    through the same functions, and their weights' shapes and names are
    as they were."""
    import json
    from pathlib import Path

    from perfbench.model_routes import dsv3mla24
    from sparsifyme_tpu_torch.models import mla

    root = Path(__file__).resolve().parents[1] / "perfbench" / "configs"
    if model == "mimo":
        cfg = mimo24.model_config(json.loads(
            (root / "mimo-v2-flash-ep8.json").read_text()))
        kind, step, shapes = "gqa", mt.attention, {"0.q": None}
    else:
        cfg = dsv3mla24.model_config(json.loads(
            (root / "deepseek-v3-ep32.json").read_text()))
        kind, step, shapes = "mla", mla.mla_attention, {
            "0.q_a": (1536, 7168), "0.q_b": (32 * 192, 1536),
            "3.kv_a": (576, 7168), "5.o": (7168, 32 * 128)}
    assert cfg.linear_attn_config is None and not cfg.mla_use_nope
    for i in range(cfg.num_hidden_layers):
        assert cfg.attention_kind_of(i) == kind
        assert mt.attention_kind(cfg, i)[1] is step
    for name, shape in shapes.items():
        if shape is not None:
            assert mt.weight_shape(cfg, name) == shape
    if model == "mimo":
        heads, kv, dqk, _, _, _, _ = cfg.attention_shape(0)
        assert mt.weight_shape(cfg, "0.q") == (heads * dqk, cfg.hidden_size)


def test_kimis_whole_forward_matches_the_reference(kimi):
    """Both outputs within 3e-2 of a reference forward that takes the
    program's choices (five layers of bf16 rounding), and the route's pass
    is the model's forward plus each MoE layer's delta."""
    route = kimi.route.KimiLinear24()
    state = (kimi.params, kimi.ids, kimi.cfg)
    got = route.run_pass(state, False)
    for a, b in zip(got, mt.forward(kimi.params, kimi.ids, kimi.cfg)):
        assert torch.equal(a, b)
    assert len(got) == route.outputs(kimi.ctx, []) == 2 + 4
    choices = [sel for _, _, sel in route._moe]
    want = kimi.route.REF.forward(kimi.ids, kimi.spec, kimi.weight,
                                  choices=choices)
    assert reference.readings(got[0], want[0])[0] < 3e-2
    assert reference.readings(got[1], want[1])[0] < 3e-2
