"""Kimi Delta Attention on the port (``models/kda.py`` and the plain
versions of ``ops/kernels/kda_kernel.py``) on the CPU: the plain chunked
form against the token recurrence in float64 (one chunk and many, packed
sequences, decays of -1.6 a token over whole chunks and stronger), the
state and the convolution reset at every sequence boundary, the glue's
plain versions against the formulas, and the whole block against the
benchmark's plain float32 reference (``perfbench/model_refs/
kimi_linear.py``) at a small size: hidden 256, 2 heads of the published
128, weights from the benchmark route's seeded generator.

Tolerances: in float64 the chunked form is the recurrence re-associated,
so 1e-12 holds; the block's products take bf16 operands and give bf16
results (about 2**-9 relative each), and q, k, v, the recurrence's output
and the gated norm's are rounded to bf16 once each, so one block reads
3-6e-3 against the float32 reference and 1e-2 holds it with room.
"""

import functools
import math
from types import SimpleNamespace

import pytest
import torch

from perfbench.model_routes import kimilinear24
from perfbench.tests.kimi_small import BATCH, KDA_LAYERS, SEQ, SMALL
from sparsifyme_tpu_torch.models import kda
from sparsifyme_tpu_torch.models import moe_transformer as mt
from sparsifyme_tpu_torch.ops.kernels import kda_kernel as kk
from sparsifyme_tpu_torch.utils import trace

REF = kimilinear24.REF
SEED = 2 ** 31 + 11
TOL = 1e-2


def _operands(heads, batch, seq, decay, seed=0, d=128):
    """Feature-major float64 q, k (unit per head), v, the log-decay ``g``
    (``decay`` times U(0.5, 1)) and
    beta."""
    g = torch.Generator().manual_seed(seed)
    t = batch * seq

    def unit():
        x = torch.randn((heads, d, t), generator=g, dtype=torch.float64)
        return (x / x.norm(dim=1, keepdim=True)).reshape(heads * d, t)

    q, k = unit(), unit()
    v = torch.randn((heads * d, t), generator=g, dtype=torch.float64)
    u = torch.rand((heads * d, t), generator=g, dtype=torch.float64)
    gd = -decay * (0.5 + 0.5 * u)
    beta = torch.rand((heads, t), generator=g, dtype=torch.float64)
    return q, k, v, gd, beta


def _rel(got, ref):
    return float((got - ref).norm() / ref.norm())


@pytest.mark.parametrize("batch,seq", [(1, 64), (1, 512), (3, 192)],
                         ids=["one_chunk", "many_chunks", "packed"])
@pytest.mark.parametrize("decay", [0.01, 1.6], ids=["weak", "strong"])
def test_the_chunked_form_is_the_token_recurrence(batch, seq, decay):
    q, k, v, g, beta = _operands(2, batch, seq, decay)
    want = kk.kda_recurrent_plain(q, k, v, g, beta, batch)
    got = kk.kda_chunk_plain(q, k, v, g, beta, batch)
    assert got.dtype == torch.float64 and got.shape == want.shape
    assert _rel(got, want) < 1e-12


def test_decays_past_floats_exp_range_stay_finite_and_exact():
    """-1.6 a token on every channel sums to -102 over a chunk and -8 a
    token to -512: past float32's exp range for exp(Gam_r) * exp(-Gam_s),
    yet each chunk's pairwise decays are formed as one exponent, so the
    chunked form stays finite and equal to the recurrence, in float32 as
    in float64."""
    for rate in (1.6, 8.0):
        q, k, v, _, beta = _operands(2, 2, 128, 1.0, seed=3)
        g = torch.full_like(q, -rate)
        want = kk.kda_recurrent_plain(q, k, v, g, beta, 2)
        got64 = kk.kda_chunk_plain(q, k, v, g, beta, 2)
        got32 = kk.kda_chunk_plain(*(t.float() for t in (q, k, v, g, beta)),
                                   2)
        assert _rel(got64, want) < 1e-12
        assert bool(torch.isfinite(got32).all())
        assert _rel(got32.double(), want) < 1e-5
        # the naive factoring overflows: exp(-Gam_s) of a chunk's end
        assert torch.isinf(torch.exp(torch.tensor(rate * 63.0)).float())


def test_a_state_rounded_each_chunk_departs_where_it_carries():
    """``state_dtype`` rounds the carried state after each chunk: bf16
    moves the output where the decays are weak (the state carries across
    chunks) and not within the first chunk, whose state starts at zero;
    float64 changes nothing."""
    q, k, v, g, beta = _operands(2, 1, 256, 0.01, seed=5)
    want = kk.kda_chunk_plain(q, k, v, g, beta, 1)
    same = kk.kda_chunk_plain(q, k, v, g, beta, 1,
                              state_dtype=torch.float64)
    rounded = kk.kda_chunk_plain(q, k, v, g, beta, 1,
                                 state_dtype=torch.bfloat16)
    assert torch.equal(same, want)
    first = slice(0, kk.CHUNK)
    assert torch.equal(rounded[:, first], want[:, first])
    rest = slice(kk.CHUNK, None)
    assert 1e-4 < _rel(rounded[:, rest], want[:, rest]) < 1e-1


def test_the_state_resets_at_each_sequence_boundary():
    """Each sequence of a packed batch reads what it reads alone."""
    q, k, v, g, beta = _operands(2, 3, 128, 0.05, seed=5)
    packed = kk.kda_chunk_plain(q, k, v, g, beta, 3)
    for b in range(3):
        cols = slice(128 * b, 128 * (b + 1))
        alone = kk.kda_chunk_plain(*(t[:, cols] for t in (q, k, v, g, beta)),
                                   1)
        assert _rel(packed[:, cols], alone) < 1e-13
    # carrying the state across the boundary reads otherwise
    carried = kk.kda_chunk_plain(q, k, v, g, beta, 1)
    assert _rel(carried[:, 128:], packed[:, 128:]) > 1e-2


def test_the_convolution_resets_at_each_sequence_boundary():
    """The plain convolution: SiLU of sum_j w_j x_{t-3+j} with zeros before
    each sequence's first token, the q and k rows then unit per head."""
    g = torch.Generator().manual_seed(7)
    heads, batch, seq = 2, 2, 64
    x = torch.randn((3 * heads * 128, batch * seq), generator=g).to(
        torch.bfloat16)
    w = (torch.rand((3 * heads * 128, 4), generator=g) - 0.5).to(
        torch.bfloat16)
    got = kk.kda_conv_plain(x, w, batch, 2 * heads * 128, 1e-6).float()
    xf, wf = x.float().view(-1, batch, seq), w.float()
    want = torch.zeros_like(xf)
    for t in range(seq):
        for j in range(4):
            if t - 3 + j >= 0:
                want[:, :, t] += wf[:, j, None] * xf[:, :, t - 3 + j]
    want = torch.nn.functional.silu(want).view(x.shape)
    qk = want[:2 * heads * 128].view(-1, 128, batch * seq)
    qk /= (qk.square().sum(1, keepdim=True) + 1e-6).sqrt()
    assert _rel(got, want) < 4e-3
    norms = got[:2 * heads * 128].view(-1, 128, batch * seq).norm(dim=1)
    assert (norms - 1).abs().max() < 1e-2


def test_the_decay_reaches_the_published_range():
    """At the seeded A_log and dt_bias a zero input decays each channel by
    -exp(A_log) * dt with exp(A_log) in [1, 16] and dt in [0.001, 0.1]: at
    most -1.6 a token, at least -0.001."""
    ctx = SimpleNamespace(device=torch.device("cpu"), seed=SEED,
                          config=SMALL)
    a_log = kimilinear24.weight(ctx, "1.A_log", (32,))
    dt_bias = kimilinear24.weight(ctx, "1.dt_bias", (4096,))
    assert a_log.dtype == dt_bias.dtype == torch.float32
    assert 0 <= float(a_log.min()) and float(a_log.max()) <= math.log(16)
    g = kk.kda_decay_plain(torch.zeros((4096, 8), dtype=torch.bfloat16),
                           a_log, dt_bias)
    assert float(g.min()) >= -1.6 and float(g.max()) <= -1e-3 + 1e-9
    assert float(g.min()) < -0.5


def test_the_gated_norm_formula():
    g = torch.Generator().manual_seed(9)
    o, gate = (torch.randn((256, 16), generator=g).to(torch.bfloat16)
               for _ in range(2))
    w = torch.rand(128, generator=g).to(torch.bfloat16)
    got = kk.kda_gate_norm_plain(o, gate, w, 1e-5).float()
    oh = o.float().view(2, 128, 16)
    want = oh / (oh.square().mean(1, keepdim=True) + 1e-5).sqrt() * \
        w.float()[:, None] * torch.sigmoid(gate.float().view(2, 128, 16))
    assert _rel(got, want.view(256, 16)) < 4e-3


def _ctx(seed=SEED):
    return SimpleNamespace(device=torch.device("cpu"), seed=seed,
                           config=SMALL, rank=0,
                           traffic={"sequences": BATCH, "seq_len": SEQ})


@pytest.fixture(scope="module")
def small():
    ctx = _ctx()
    params, ids, cfg = kimilinear24.KimiLinear24().setup(ctx, [])
    return SimpleNamespace(ctx=ctx, params=params, ids=ids, cfg=cfg,
                           spec=kimilinear24.ref_spec(SMALL),
                           weight=functools.partial(kimilinear24.kept_weight,
                                                    ctx))


def _hidden(seed=1, tokens=BATCH * SEQ, width=256):
    g = torch.Generator().manual_seed(seed)
    return torch.randn((tokens, width), generator=g)


@pytest.mark.parametrize("layer", KDA_LAYERS[:2])
def test_the_kda_block_matches_the_reference(small, layer):
    h = _hidden(layer)
    attn, _ = small.params.layers[layer]
    assert isinstance(attn, kda.Kda)
    got = kda.kda_attention(attn, h.T.contiguous(), small.cfg, BATCH) - h.T
    x = REF.rms_norm(h, torch.ones(256), small.cfg.layernorm_epsilon)
    want = REF.kda(x, small.spec, layer, small.weight, BATCH)
    assert _rel(got.T, want) < TOL


def test_the_kda_record_its_counters_and_its_products(small):
    """``sparsifyme.kda`` and its six phases, ``kda.tokens`` (tokens x
    heads), ``products()`` entered around qkv and around o, ``core()``
    around the recurrence; no kernel launched on the CPU."""
    entered = []

    def tagged(name):
        import contextlib

        @contextlib.contextmanager
        def ctx():
            entered.append(name)
            yield
        return ctx

    attn, _ = small.params.layers[KDA_LAYERS[0]]
    h = _hidden(3).T.contiguous()
    trace.reset()
    with trace.recording():
        kda.kda_attention(attn, h, small.cfg, BATCH, tagged("products"),
                          tagged("core"))
    summary = trace.summary()
    trace.reset()
    assert entered == ["products", "core", "products"]
    spans = summary["spans"]
    assert spans["sparsifyme.kda"]["count"] == 1
    for phase in ("proj", "conv", "gate", "chunk", "norm", "out"):
        assert spans["sparsifyme.kda." + phase]["count"] == 1, phase
    assert summary["counters"]["kda.tokens"] == 2 * BATCH * SEQ
    assert "kda.kernel" not in summary["counters"]


def test_the_weights_and_their_shapes(small):
    cfg = small.cfg
    assert kda.dims(cfg) == (2, 128, 4)
    attn, _ = small.params.layers[0]
    assert attn.qkv.shape == (3 * 256, 256) and attn.o.shape == (256, 256)
    assert attn.low.shape == (2 * 128 + 2, 256)
    assert attn.conv.shape == (3 * 256, 4) and attn.conv.dtype == \
        torch.bfloat16
    assert attn.a_log.dtype == attn.dt_bias.dtype == torch.float32
    for part in kda.SHAPES:
        assert mt.weight_shape(cfg, f"0.{part}") == kda.weight_shape(cfg,
                                                                     part)
    dense = mt.densify(small.params)
    d_attn, _ = dense.layers[0]
    assert not isinstance(d_attn.qkv, type(attn.qkv))
    assert d_attn.qkv.shape == attn.qkv.shape
