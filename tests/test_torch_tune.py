"""Port parity: the tuner (``bench/tune.py``), the tuning table, the
harness's tuned path and its measurement guards, and the plan's table
entry, on the CPU.

Every candidate the tuner races computes the product of the op it tunes:
each 2:4 and ELL candidate equals the port's dense oracle
(``spmm_24_reference`` / ``spmm_ell_reference``) and the JAX op on the same
numpy inputs, within 1e-5 relative in f32 and 2e-2 in bf16 (relative to
the largest reference magnitude). A table entry makes the harness race
exactly the winner and its one alternative (counted, as
``tests/test_tuning.py`` does for the JAX harness).
"""

import json
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import sparsifyme_tpu.bench.tuning as jtuning
from sparsifyme_tpu.bench import harness as jharness
from sparsifyme_tpu.ops import ell as je
from sparsifyme_tpu.ops import prune as jprune
from sparsifyme_tpu.ops import sparse24 as js
from sparsifyme_tpu_torch import plan as tplan
from sparsifyme_tpu_torch.bench import harness, tune, tuning
from sparsifyme_tpu_torch.bench.roofline import spmm24_sol_ms
from sparsifyme_tpu_torch.convert import tensor_from_numpy, tensor_to_numpy
from sparsifyme_tpu_torch.ops import ell as te
from sparsifyme_tpu_torch.ops import prune as tprune
from sparsifyme_tpu_torch.ops import sparse24 as ts
from sparsifyme_tpu_torch.ops.kernels import ell_kernel, spmm24_kernel
from sparsifyme_tpu_torch.utils.shapes import LayerShape
from sparsifyme_tpu_torch.utils.timing import PairTiming, Timing

TINY = (64, 16, 64, 2)  # m, n, k, b: every family has several candidates
DTYPES = [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)]
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


def _rel(out, ref) -> float:
    out = np.asarray(out, np.float32)
    ref = np.asarray(ref, np.float32)
    assert out.shape == ref.shape
    return float(np.abs(out - ref).max() / np.abs(ref).max())


def _rows(out: torch.Tensor, cand, rows: int, n: int) -> np.ndarray:
    """A candidate's product as ``[rows, n]``: C^T transposed back."""
    out = tensor_to_numpy(out)
    return out.T if cand.get("transpose_out") else out.reshape(rows, n)


def test_tune_shape_returns_every_family_from_its_candidates():
    m, n, k, b = TINY
    log = tune.TuneLog()
    entry = tune.tune_shape(m, n, k, b, iters=1, reps=1, device="cpu",
                            log=log)
    assert set(entry) == {"gemm", "spmm24", "fused", "ell", "card"}
    assert entry["card"] == "cpu"
    cands = {"gemm": tune.gemm_candidates(),
             "spmm24": tune.spmm24_candidates(m, n, k, b),
             "fused": tune.fused_candidates(m, k, b),
             "ell": tune.ell_candidates(m, n, k, b)}
    for family, winner in entry.items():
        if family == "card":
            continue
        assert winner["ms"] > 0
        assert {x: y for x, y in winner.items() if x != "ms"} in \
            cands[family], family
        assert log.candidates[family] == len(cands[family])
    assert log.discards == []
    assert len(cands["spmm24"]) == 11  # 4 tiles x 2 layouts, packed, fold
    assert cands["fused"] == [{"fold": 1}, {"fold": 2}]


@pytest.mark.parametrize("jdt,tdt", DTYPES)
def test_every_spmm24_candidate_matches_the_oracle_and_jax(rng, jdt, tdt):
    m, n, k, b = TINY
    a = np.asarray(jnp.asarray(rng.normal(size=(b, m, k)), jdt))
    bm = np.asarray(jnp.asarray(rng.normal(size=(k, n)), jdt))
    ta, tb = tensor_from_numpy(a, "cpu"), tensor_from_numpy(bm, "cpu")
    pruned = tprune.prune_nm(ta, 2, 4)[0]
    s = ts.compress_24(pruned)
    s_fold = ts.prune_compress_24(pruned, fold=2)
    oracle = tensor_to_numpy(ts.spmm_24_reference(
        s, tb, out_dtype=torch.float32)).reshape(b * m, n)
    jout = np.asarray(js.spmm_24(
        js.compress_24(jprune.prune_nm(jnp.asarray(a), 2, 4)[0]),
        jnp.asarray(bm), out_dtype=jnp.float32)).reshape(b * m, n)
    for cand in tune.spmm24_candidates(m, n, k, b, full=True):
        fn, ops = harness.spmm24_call(cand, s, s_fold, tb, tdt)
        got = _rows(fn(*ops), cand, b * m, n)
        assert _rel(got, oracle) < TOL[tdt], cand
        assert _rel(got, jout) < TOL[tdt], cand


@pytest.mark.parametrize("jdt,tdt", DTYPES)
@pytest.mark.parametrize("shape", [TINY, (100, 24, 147, 2)])
def test_every_ell_candidate_matches_the_oracle_and_jax(rng, jdt, tdt,
                                                        shape):
    m, n, k, b = shape
    a = np.asarray(jnp.asarray(rng.normal(size=(b, m, k)), jdt))
    bm = np.asarray(jnp.asarray(rng.normal(size=(k, n)), jdt))
    ta, tb = tensor_from_numpy(a, "cpu"), tensor_from_numpy(bm, "cpu")
    cands = tune.ell_candidates(m, n, k, b, full=True)
    assert {c["formulation"] for c in cands} == {"gather", "expand"}
    for key in dict.fromkeys((c["block_k"], c["fold_first"]) for c in cands):
        e, kp = harness.build_ell_operand(ta, block_size=128, block_k=key[0],
                                          fold_first=key[1])
        bp = F.pad(tb, (0, 0, 0, kp - k))
        rows = e.values.reshape(-1, e.values.shape[-1]).shape[0]
        oracle = tensor_to_numpy(te.spmm_ell_reference(
            e, bp, out_dtype=torch.float32)).reshape(rows, n)
        je_, jkp = jharness.build_ell_operand(
            jnp.asarray(a), block_size=128, block_k=key[0],
            fold_first=key[1])
        assert jkp == kp
        jout = np.asarray(je.spmm_ell(
            je_, jnp.pad(jnp.asarray(bm), ((0, kp - k), (0, 0))),
            out_dtype=jnp.float32)).reshape(rows, n)
        for cand in (c for c in cands
                     if (c["block_k"], c["fold_first"]) == key):
            fn, ops = harness.ell_call(cand, e, bp, tdt)
            got = _rows(fn(*ops), cand, rows, n)
            assert _rel(got, oracle) < TOL[tdt], cand
            assert _rel(got, jout) < TOL[tdt], cand


@pytest.mark.parametrize("shape", [(3136, 128, 1152, 32),
                                   (12544, 256, 64, 32),
                                   (196, 512, 4608, 32),
                                   (12544, 64, 147, 32)])
def test_candidates_are_filtered_before_launch(shape):
    """Only what the card can run is raced: packed where k <= 1024, fold=2
    where k4 <= 256 and b*m is even, the fused fold where k <= 160, ELL
    edges K4/K5 take, and every forced plan one that ell_plan admits."""
    m, n, k, b = shape
    s24 = tune.spmm24_candidates(m, n, k, b)
    assert any(c["packed"] for c in s24) == (k <= 1024)
    assert any(c["fold"] == 2 for c in s24) == (k <= 1024)
    assert {c["tile"] for c in s24 if not c["packed"] and c["fold"] == 1} \
        == set(range(len(spmm24_kernel.SP_TILES)))
    assert any(c["fold"] == 2 for c in tune.fused_candidates(m, k, b)) == \
        (k <= 160)
    ell = tune.ell_candidates(m, n, k, b)
    assert {c["block_k"] for c in ell} <= set(ell_kernel.BLOCK_KS)
    assert harness.heuristic_block_k(k) in {c["block_k"] for c in ell}
    assert any(c["formulation"] == "expand" for c in ell) == (k <= 1024)
    for c in ell:
        if c["block_n"] is None:
            continue
        ellb = (-(-k // (2 * c["block_k"])) * 2 * c["block_k"]) \
            // c["block_k"] // 2
        assert ell_kernel.ell_plan(
            tune.ell_rows(m, b, c["fold_first"]), n, ellb, c["block_k"],
            128, widths=(c["block_n"],), split_counts=(c["splits"],))
    # by default: the pick, one other width and one other split count
    plans = {(c["block_k"], c["block_n"], c["splits"]) for c in ell
             if c["formulation"] == "gather"}
    assert len(plans) <= 3 * len({c["block_k"] for c in ell})


def test_ell_plans_full_takes_every_admitted_plan():
    rows, n, ell, bk = 3136 * 32, 128, 9, 64
    full = tune.ell_plans(rows, n, ell, bk, full=True)
    want = {(bn, s) for bn in ell_kernel.TILE_NS
            for s in range(1, ell_kernel.MAX_SPLITS + 1)
            if ell_kernel.ell_plan(rows, n, ell, bk, 128, widths=(bn,),
                                   split_counts=(s,))}
    assert set(full) == want and len(full) == len(want)
    pick = ell_kernel.ell_plan(rows, n, ell, bk, 128)
    assert full[0] == (pick.bn, pick.splits)
    assert tune.ell_plans(rows, n, ell, bk)[0] == full[0]
    assert tune.ell_plans(rows, n, ell, 16) == [(None, None)]


def test_ell_edges_follow_the_jax_tuner():
    """Heuristic, alternative and no-pad edges (JAX ``tune.py:265-295``)
    within the edges the port's kernels take."""
    assert tune.ell_edges(64) == [32, 128]
    assert tune.ell_edges(147) == [16, 32, 64]
    assert tune.ell_edges(576) == [32, 64, 128]
    assert tune.ell_edges(1152) == [64, 128]
    assert tune.ell_edges(4608) == [64, 128]
    assert tune.ell_edges(1152, full=True) == [32, 64, 128]


def test_table_round_trips_in_the_jax_bytes(tmp_path):
    m, n, k, b = TINY
    entry = tune.tune_shape(m, n, k, b, ("gemm", "fused"), iters=1, reps=1,
                            device="cpu")
    table = {tuning.shape_key(m, n, k, b): entry,
             "8x8x8x1": {"gemm": {"fold": False, "ms": 1.5}, "card": "cpu"}}
    ours, theirs = tmp_path / "t.json", tmp_path / "j.json"
    tuning.save_table(table, str(ours))
    jtuning.save_table(table, str(theirs))
    assert ours.read_bytes() == theirs.read_bytes()
    assert tuning.lookup(m, n, k, b, path=str(ours)) == entry
    assert tuning.lookup(m, n, k, b + 1, path=str(ours)) is None
    assert json.loads(ours.read_text()) == table


def test_tune_main_saves_after_every_shape(tmp_path, monkeypatch, capsys):
    shapes = [LayerShape(8, 8, 64, 1), LayerShape(16, 8, 64, 1)]
    monkeypatch.setattr(tune, "resnet_conv_shapes", lambda name: shapes)
    calls = []

    def fake(m, n, k, b, ops, **kw):
        calls.append((m, tuple(ops)))
        path = str(tmp_path / "t.json")
        assert len(tuning.load_table(path)) == len(calls) - 1
        return {"gemm": {"fold": True, "ms": 1.0}, "card": "cpu"}

    monkeypatch.setattr(tune, "tune_shape", fake)
    monkeypatch.setattr(tune._build, "build_all", lambda: None)  # no nvcc
    path = str(tmp_path / "t.json")
    assert tune.main(["--table", path, "--ops", "gemm"]) == 0
    assert [c[0] for c in calls] == [8, 16]
    assert set(tuning.load_table(path)) == {"8x8x64x1", "16x8x64x1"}
    assert tune.main(["--table", path, "--ops", "gemm"]) == 0
    assert "already tuned" in capsys.readouterr().out and len(calls) == 2
    tune.main(["--table", path, "--ops", "gemm", "--fresh",
               "--shapes", "16x8x64x1"])
    assert [c[0] for c in calls] == [8, 16, 16]


# --- the harness's tuned path ---------------------------------------------

@pytest.fixture
def spies(monkeypatch):
    """Record the configuration of every call of the harness's gemm, fused
    route and SpMMs."""
    seen = {"gemm": set(), "fused": set(), "spmm24": set(), "ell": set()}

    def wrap(name, family, key):
        real = getattr(harness, name)

        def spy(*args, **kw):
            seen[family].add(key(args, kw))
            return real(*args, **kw)
        monkeypatch.setattr(harness, name, spy)

    wrap("batched_gemm", "gemm", lambda a, kw: ("fold", kw["fold"]))
    wrap("prune_compress_24", "fused",
         lambda a, kw: ("fold", kw.get("fold", 1), a[0].ndim))
    wrap("spmm_24", "spmm24", lambda a, kw: (
        kw.get("tile"), kw.get("transpose_out", False), False,
        int(a[0].fold)))
    wrap("spmm24_plain", "spmm24", lambda a, kw: (
        kw.get("tile"), kw["transpose_out"], kw["packed_codes"], 1))
    wrap("spmm_ell", "ell", lambda a, kw: (
        "gather", kw["transpose_out"], kw["block_n"], kw["splits"]))
    wrap("ell_expand_spmm_plain", "ell",
         lambda a, kw: ("expand", kw["transpose_out"], None, None))
    return seen


def _with_table(monkeypatch, tmp_path, shape, entry):
    path = str(tmp_path / "table.json")
    tuning.save_table({tuning.shape_key(*shape): entry}, path)
    monkeypatch.setattr(tuning, "TABLE_PATH", path)
    tuning._load.cache_clear()


S24 = {"tile": 2, "transpose_out": False, "packed": False, "fold": 1}
ELL = {"formulation": "gather", "transpose_out": True, "block_size": 128,
       "block_k": 32, "fold_first": True, "block_n": 64, "splits": 1}
ENTRIES = [
    # (spmm24 winner, ell winner, the spmm24 / ell calls expected)
    (S24, ELL,
     {(2, False, False, 1), (None, True, False, 1)},
     {("gather", True, 64, 1), ("gather", False, None, None)}),
    (dict(S24, tile=None, packed=True), dict(ELL, formulation="expand",
                                             block_n=None, splits=None),
     {(None, False, True, 1), (None, True, False, 1)},
     {("expand", True, None, None), ("gather", False, None, None)}),
    (dict(S24, tile=None, fold=2), dict(ELL, transpose_out=False, splits=2),
     {(None, False, False, 2), (None, True, False, 1)},
     {("gather", False, 64, 2), ("gather", True, None, None)}),
    # the winner is the default: raced alone
    (dict(S24, tile=None, transpose_out=True), ELL,
     {(None, True, False, 1)},
     {("gather", True, 64, 1), ("gather", False, None, None)}),
]


@pytest.mark.parametrize("e24,eell,want24,wantell", ENTRIES)
def test_table_entry_races_the_winner_and_one_alternative(
        tmp_path, monkeypatch, spies, e24, eell, want24, wantell):
    shape = TINY
    _with_table(monkeypatch, tmp_path, shape, {
        "gemm": {"fold": False, "ms": 1.0}, "fused": {"fold": 2, "ms": 1.0},
        "spmm24": dict(e24, ms=1.0), "ell": dict(eell, ms=1.0),
        "card": "cpu"})
    out = harness.bench_shape(LayerShape(*shape), iters=1, reps=1,
                              device="cpu")
    tuning._load.cache_clear()
    assert spies["gemm"] == {("fold", False)}
    # the fused route on the dense operand runs the tuned fold (and, for a
    # fold=2 winner, once more on the pruned operand to build its planes)
    assert ("fold", 2, 3) in spies["fused"]
    assert ("fold", 1, 3) not in spies["fused"]
    assert spies["spmm24"] == want24
    assert spies["ell"] == wantell
    for key in ("gemm_ms", "fused_ms", "spmm24_ms", "ell_ms"):
        assert out[key] > 0 and math.isfinite(out[key])
    # the published bound is the shape's, whichever entry the table holds
    assert out["sol24_ms"] == spmm24_sol_ms(*shape)


def test_a_packed_winner_is_guarded_by_its_own_bound(tmp_path, monkeypatch):
    """The packed winner's readings are held to the packed bound, the
    default's to the unpacked one; ``sol24_ms`` stays the unpacked bound,
    as on a shape without an entry."""
    shape = TINY
    _with_table(monkeypatch, tmp_path, shape, {
        "spmm24": dict(S24, tile=None, packed=True, ms=1.0), "card": "cpu"})
    floors = []
    real = harness._guarded

    def spy(fn, operands, floor_ms, *, iters, reps, what=""):
        if "spmm24 candidate" in what:
            floors.append(floor_ms)
        return real(fn, operands, floor_ms, iters=iters, reps=reps,
                    what=what)

    monkeypatch.setattr(harness, "_guarded", spy)
    out = harness.bench_shape(LayerShape(*shape), kernels=("spmm24",),
                              iters=1, reps=1, device="cpu")
    tuning._load.cache_clear()
    assert floors == [spmm24_sol_ms(*shape, packed_codes=True),
                      spmm24_sol_ms(*shape)]
    assert floors[0] < floors[1]
    assert out["sol24_ms"] == spmm24_sol_ms(*shape)


def test_shape_without_an_entry_races_the_untuned_candidates(
        tmp_path, monkeypatch, spies):
    _with_table(monkeypatch, tmp_path, (8, 8, 8, 1), {"card": "cpu"})
    harness.bench_shape(LayerShape(*TINY), iters=1, reps=1, device="cpu")
    tuning._load.cache_clear()
    assert spies["gemm"] == {("fold", True), ("fold", False)}
    assert spies["fused"] == {("fold", 1, 3)}
    assert spies["spmm24"] == {(None, False, False, 1),
                               (None, True, False, 1)}
    assert spies["ell"] == {("gather", False, None, None),
                            ("gather", True, None, None),
                            ("expand", False, None, None),
                            ("expand", True, None, None)}


# --- the measurement guards -------------------------------------------------

def _timings(monkeypatch, values):
    calls = []

    def fake(fn, operands, *, iters, reps):
        calls.append(reps)
        ms = values[min(len(calls), len(values)) - 1]
        return Timing(ms=ms, ms_min=ms, iters=iters, reps=reps)

    monkeypatch.setattr(harness, "time_kernel", fake)
    return calls


def test_guarded_remeasures_a_sub_bound_reading(monkeypatch, capsys):
    calls = _timings(monkeypatch, [0.5, 2.0])
    t = harness._guarded(lambda: None, (), 1.0, iters=4, reps=1, what="x")
    assert t.ms == 2.0 and calls == [1, 3]
    assert "re-measured: 2.0000 ms" in capsys.readouterr().out
    calls = _timings(monkeypatch, [0.9])
    assert harness._guarded(lambda: None, (), 1.0, iters=4, reps=2).ms == 0.9
    assert calls == [2]


def test_tuner_discards_a_reading_still_under_its_bound(monkeypatch,
                                                         capsys):
    calls = _timings(monkeypatch, [0.5, 0.6])
    log = tune.TuneLog()
    ms = tune._time(lambda: None, (), 4, 2, 1.0, "8x8x8x1 gemm {}", log)
    assert ms == math.inf and calls == [2, 3]
    assert log.discards == ["8x8x8x1 gemm {}"]
    assert "discarded" in capsys.readouterr().out


def test_paired_remeasures_a_spread_pair_at_most_twice(monkeypatch, capsys):
    calls = []

    def pair(fa, oa, fb, ob, *, iters, reps):
        calls.append(reps)
        t = Timing(ms=1.0, ms_min=1.0, iters=iters, reps=reps)
        return PairTiming(a=t, b=t, ratio=1.0, ratio_spread=2.0)

    monkeypatch.setattr(harness, "time_kernel_pair", pair)
    dense = (lambda: None, ())
    out = harness._paired(dense, lambda: None, (), 0.1, 0.1, iters=4,
                          reps=1, what="x")
    assert calls == [1, 3, 3] and out[3] == 2.0
    assert capsys.readouterr().out.count("re-measured") == 2


# --- the plan reads the port's entry ---------------------------------------

def test_spmma_plan_takes_tile_packed_and_fold_from_the_entry(monkeypatch):
    entry = {"tile": 2, "transpose_out": True, "packed": True, "fold": 1}
    monkeypatch.setattr(tuning, "lookup",
                        lambda m, n, k, b=1: {"spmm24": entry})
    p = tplan.SpmmaPlan(tplan.SpmmaConfig(m=32, n=16, k=64, batch=2))
    assert p.tile == 2 and p._packed and p._fold == 1
    assert p.algorithm == (None, None, None, False, True, True)
    assert p._matmul.keywords["tile"] == 2
    entry = {"tile": None, "transpose_out": False, "packed": False,
             "fold": 2}
    monkeypatch.setattr(tuning, "lookup",
                        lambda m, n, k, b=1: {"spmm24": entry})
    p = tplan.SpmmaPlan(tplan.SpmmaConfig(m=32, n=16, k=64, batch=2))
    assert p.tile is None and not p._packed and p._fold == 2
    # an explicit tiling wins: the table is not read
    p = tplan.SpmmaPlan(tplan.SpmmaConfig(m=32, n=16, k=64, batch=2,
                                          block_m=128))
    assert p.tile is None and p._fold == 1


def test_spmma_plan_with_a_tuned_tile_matches_jax(rng, monkeypatch):
    monkeypatch.setattr(tuning, "lookup", lambda m, n, k, b=1: {
        "spmm24": {"tile": 3, "transpose_out": True, "packed": True,
                   "fold": 1}})
    p = tplan.SpmmaPlan(tplan.SpmmaConfig(m=32, n=16, k=64,
                                          dtype="float32"))
    a = rng.normal(size=(32, 64)).astype(np.float32)
    bm = rng.normal(size=(64, 16)).astype(np.float32)
    got = tensor_to_numpy(p(tensor_from_numpy(a, "cpu"),
                            tensor_from_numpy(bm, "cpu")))
    want = np.asarray(js.spmm_24(js.compress_24(jprune.prune_nm(
        jnp.asarray(a), 2, 4)[0]), jnp.asarray(bm), out_dtype=jnp.float32))
    assert _rel(got, want) < 1e-5


def test_forced_ell_plan_refused_before_any_launch():
    """The wrappers' plan check raises in Python before the card is
    touched: a width outside TILE_NS, a split count outside 1..8, or any
    forced knob where the Hopper tile does not apply (f32)."""
    args = (torch.device("cpu"), 128, 64, 2, 32, 128)
    with pytest.raises(ValueError, match="block_n 96"):
        ell_kernel._plan_for(*args, torch.bfloat16, (), 96, None)
    with pytest.raises(ValueError, match="splits 9"):
        ell_kernel._plan_for(*args, torch.bfloat16, (), None, 9)
    with pytest.raises(ValueError, match="no plan"):
        ell_kernel._plan_for(*args, torch.float32, (), 64, 1)
    assert ell_kernel._plan_for(*args, torch.float32, ()) is None


def test_plain_versions_ignore_the_knobs(rng):
    x = torch.from_numpy(rng.normal(size=(2, 32, 64)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(64, 8)).astype(np.float32))
    s = ts.prune_compress_24(x)
    assert torch.equal(ts.spmm_24(s, b, tile=0), ts.spmm_24(s, b))
    e = te.ell_from_dense(F.pad(x, (0, 0, 0, 96)), 128, 1, 32)
    assert torch.equal(te.spmm_ell(e, b, block_n=256, splits=7),
                       te.spmm_ell(e, b))
