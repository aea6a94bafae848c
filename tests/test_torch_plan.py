"""Port parity: the SpMMA plan (``plan.py``) and the tuning table against
the JAX package's on the CPU, on the same numpy inputs.

Phases that are exact in both packages (prune, compress, the fused
prune+compress) must be bit-identical; products agree within 1e-5 relative
in f32 (both accumulate in f32, in different orders).
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sparsifyme_tpu.bench.tuning as jtuning
import sparsifyme_tpu_torch.bench.tuning as ttuning
from sparsifyme_tpu import plan as jplan
from sparsifyme_tpu_torch import plan as tplan
from sparsifyme_tpu_torch.convert import tensor_from_numpy, tensor_to_numpy

TOL = 1e-5


def _both(rng, shape):
    x = rng.normal(size=shape).astype(np.float32)
    return jnp.asarray(x), tensor_from_numpy(x, "cpu")


def _rel(j, t):
    ref = np.asarray(j, np.float32)
    return np.abs(tensor_to_numpy(t) - ref).max() / np.abs(ref).max()


def _plans(monkeypatch=None, entry=None, **cfg):
    """One plan per package for the same config; ``entry`` is the spmm24
    tuning-table entry both see."""
    if entry is not None:
        for mod in (jtuning, ttuning):
            monkeypatch.setattr(mod, "lookup",
                                lambda m, n, k, b=1: {"spmm24": entry})
    return (jplan.SpmmaPlan(jplan.SpmmaConfig(**cfg)),
            tplan.SpmmaPlan(tplan.SpmmaConfig(**cfg)))


F32 = dict(dtype="float32", out_dtype="float32")


def test_plan_phases(rng):
    jp, tp = _plans(m=32, n=16, k=64, **F32)
    ja, ta = _both(rng, (32, 64))
    jb, tb = _both(rng, (64, 16))
    jpr, tpr = jp.prune(ja), tp.prune(ta)
    assert np.array_equal(np.asarray(jpr), tensor_to_numpy(tpr))
    assert tp.prune_check(tpr) is True and bool(jp.prune_check(jpr))
    assert tp.prune_check(ta) is False
    s, q = jp.compress(jpr), tp.compress(tpr)
    assert np.array_equal(np.asarray(s.codes), tensor_to_numpy(q.codes))
    c = tp.matmul(q, tb)
    assert c.dtype == torch.float32 and tuple(c.shape) == (32, 16)
    assert _rel(jp.matmul(s, jb), c) < TOL


def test_plan_fused_matches_phases(rng):
    """plan(a, b) runs the fused prune+compress: the same planes as the
    phases, so the same product bit for bit."""
    jp, tp = _plans(m=16, n=8, k=32, **F32)
    ja, ta = _both(rng, (16, 32))
    jb, tb = _both(rng, (32, 8))
    fused = tp(ta, tb)
    assert torch.equal(fused, tp.matmul(tp.compress(tp.prune(ta)), tb))
    assert _rel(jp(ja, jb), fused) < TOL


def test_plan_operand_cache(rng):
    jp, tp = _plans(m=16, n=8, k=32, **F32)
    ja, ta = _both(rng, (16, 32))
    s, q = jp.compress(jp.prune(ja)), tp.compress(tp.prune(ta))
    jp.set_operand(s)
    tp.set_operand(q)
    jb1, tb1 = _both(rng, (32, 8))
    jb2, tb2 = _both(rng, (32, 8))
    c1, c2 = tp.matmul_cached(tb1), tp.matmul_cached(tb2)
    assert torch.equal(c1, tp.matmul(q, tb1))
    assert not torch.allclose(c1, c2)
    assert _rel(jp.matmul_cached(jb2), c2) < TOL
    with pytest.raises(ValueError, match="set_operand"):
        tplan.SpmmaPlan(tplan.SpmmaConfig(16, 8, 32)).matmul_cached(tb1)


def test_get_plan_caches():
    cfg = tplan.SpmmaConfig(m=16, n=8, k=32)
    assert cfg.key() == jplan.SpmmaConfig(m=16, n=8, k=32).key()
    assert tplan.get_plan(cfg) is tplan.get_plan(
        tplan.SpmmaConfig(m=16, n=8, k=32))
    assert tplan.get_plan(cfg) is not tplan.get_plan(
        tplan.SpmmaConfig(m=16, n=8, k=64))


def test_spmma_one_shot_timed(rng):
    ja, ta = _both(rng, (4, 16, 32))
    jb, tb = _both(rng, (32, 8))
    out, times = tplan.spmma(ta, tb, timed=True)
    jout, jtimes = jplan.spmma(ja, jb, timed=True)
    assert tuple(out.shape) == jout.shape == (4, 16, 8)
    assert out.dtype == torch.float32
    assert set(times) == set(jtimes) == {"prune", "compress", "mul", "fused"}
    assert all(t.ms > 0 for t in times.values())
    assert _rel(jout, out) < TOL
    assert _rel(jplan.spmma(ja, jb), tplan.spmma(ta, tb)) < TOL


def test_spmma_bf16_config_and_out_dtype(rng):
    x = rng.normal(size=(2, 16, 64)).astype(np.float32)
    a = torch.from_numpy(x).to(torch.bfloat16)
    out = tplan.spmma(a, torch.randn(64, 8).to(torch.bfloat16),
                      out_dtype=torch.bfloat16)
    assert out.dtype == torch.bfloat16 and tuple(out.shape) == (2, 16, 8)
    cfg = tplan.SpmmaConfig(m=16, n=8, k=64, batch=2,
                            out_dtype="bfloat16")
    assert tplan.get_plan(cfg).out_dtype == torch.bfloat16
    with pytest.raises(ValueError, match="unknown dtype"):
        tplan.SpmmaPlan(tplan.SpmmaConfig(16, 8, 64, dtype="bf16"))


def test_unaligned_plan_warns_like_jax():
    with pytest.warns(UserWarning, match="multiples of 8"):
        jplan.SpmmaPlan(jplan.SpmmaConfig(m=12, n=8, k=30))
    with pytest.warns(UserWarning, match="multiples of 8"):
        tplan.SpmmaPlan(tplan.SpmmaConfig(m=12, n=8, k=30))


@pytest.mark.parametrize("cands", [
    ((None, None, None, False), (128, 128, 16, True)),
    ((None, None, None, False, True, False, 2),
     (None, None, None, False, True, False, 1, 24)),
    None,
])
def test_matmul_search_pins_algorithm(rng, cands):
    """cusparseLtMatmulSearch analog: the winner is pinned and the plan's
    matmul stays correct with it (a C^T winner returns C^T, as in JAX)."""
    m, k, n = 32, 64, 48
    jp, tp = _plans(m=m, n=n, k=k, out_dtype="float32")
    ja, ta = _both(rng, (m, k))
    jb, tb = _both(rng, (k, n))
    s, q = jp.compress(jp.prune(ja)), tp.compress(tp.prune(ta))
    want = np.asarray(jp.matmul(s, jb))
    tp.set_operand(q)
    alg = tp.matmul_search(q, tb, candidates=cands, iters=1, reps=1)
    assert tp.algorithm == alg
    if cands is not None:
        assert alg in cands
    got = tensor_to_numpy(tp.matmul(q, tb))
    cached = tensor_to_numpy(tp.matmul_cached(tb))
    if alg[3]:  # C^T winner
        got, cached = got.T, cached.T
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(cached, want, rtol=TOL, atol=TOL)
    fused = tensor_to_numpy(tp(ta, tb))
    np.testing.assert_allclose(fused.T if alg[3] else fused, want, rtol=TOL,
                               atol=TOL)


def test_plan_row_chunks_only_table_entry(rng, monkeypatch):
    """A table entry with only TPU scheduling knobs builds a plan whose
    matmul runs (JAX: behind its eval_shape guard; the port ignores
    them)."""
    jp, tp = _plans(monkeypatch, {"pipeline": True, "row_chunks": 3},
                    m=32, n=16, k=64, **F32)
    assert tp.algorithm == jp.algorithm
    ja, ta = _both(rng, (32, 64))
    jb, tb = _both(rng, (64, 16))
    q = tp.compress(tp.prune(ta))
    want = np.asarray(jp.prune(ja), np.float64) @ np.asarray(jb, np.float64)
    np.testing.assert_allclose(tensor_to_numpy(tp.matmul(q, tb)), want,
                               rtol=1e-4, atol=1e-4)


def test_plan_packed_operand_prepacked(rng, monkeypatch):
    """A packed-codes table entry: set_operand packs once, matmul_cached
    reads the pre-packed codes, and the result matches JAX."""
    jp, tp = _plans(monkeypatch, {"pipeline": True, "packed": True},
                    m=32, n=16, k=64, **F32)
    assert tp._packed and tp.algorithm == jp.algorithm
    ja, ta = _both(rng, (32, 64))
    jb, tb = _both(rng, (64, 16))
    s, q = jp.compress(jp.prune(ja)), tp.compress(tp.prune(ta))
    jp.set_operand(s)
    tp.set_operand(q)
    assert tuple(tp._operand_packed.shape) == (8, 32)
    assert np.array_equal(np.asarray(jp._operand_packed),
                          tensor_to_numpy(tp._operand_packed))
    c = tp.matmul_cached(tb)
    assert _rel(jp.matmul_cached(jb), c) < TOL
    assert torch.allclose(c, tp.matmul(q, tb), rtol=TOL, atol=TOL)


def test_plan_folded_table_winner(rng, monkeypatch):
    """A fold=2 table entry routes plan(a, b) through the folded layout
    end to end, as in JAX."""
    jp, tp = _plans(monkeypatch, {"pipeline": True, "fold": 2},
                    m=32, n=16, k=64, **F32)
    ja, ta = _both(rng, (32, 64))
    jb, tb = _both(rng, (64, 16))
    calls = []
    real = tplan.prune_compress_24
    monkeypatch.setattr(tplan, "prune_compress_24",
                        lambda a, fold=1: calls.append(fold) or real(
                            a, fold=fold))
    out = tp(ta, tb)
    assert calls == [2]
    assert _rel(jp(ja, jb), out) < TOL
    want = np.asarray(jp.prune(ja), np.float64) @ np.asarray(jb, np.float64)
    np.testing.assert_allclose(tensor_to_numpy(out), want, rtol=1e-4,
                               atol=1e-4)


def test_tuning_table_round_trip(tmp_path):
    """lookup returns None without a table file (none is committed), and a
    saved table reads back in the JAX schema."""
    assert ttuning.shape_key(12544, 64, 147, 32) == jtuning.shape_key(
        12544, 64, 147, 32)
    missing = str(tmp_path / "none.json")
    assert ttuning.lookup(1, 2, 3, 4, path=missing) is None
    table = {"8x16x64x1": {"spmm24": {"fold": 2}}}
    path = str(tmp_path / "t.json")
    ttuning.save_table(table, path)
    assert ttuning.load_table(path) == table
    assert ttuning.lookup(8, 16, 64, 1, path=path) == {"spmm24": {"fold": 2}}
    with open(path) as f:
        assert json.load(f) == table
    assert jtuning.lookup(8, 16, 64, 1, path=path) == {"spmm24": {"fold": 2}}
