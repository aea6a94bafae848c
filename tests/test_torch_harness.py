"""Port parity: shape data, the benchmark harness on the CPU, and the
whole port so far (prune -> compress -> 2:4 SpMM, the plan's spmma and the
fold=2 route, ELL build -> gather and expand SpMM) end to end against the
JAX package."""

import csv
import json
import math
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparsifyme_tpu import plan as jplan
from sparsifyme_tpu.models import resnet_shapes as jshapes
from sparsifyme_tpu.ops import ell as je
from sparsifyme_tpu.ops import prune as jprune
from sparsifyme_tpu.ops import sparse24 as js
from sparsifyme_tpu_torch import plan as tplan
from sparsifyme_tpu_torch.bench import harness, roofline
from sparsifyme_tpu_torch.convert import tensor_from_numpy, tensor_to_numpy
from sparsifyme_tpu_torch.models import resnet_shapes as tshapes
from sparsifyme_tpu_torch.ops import ell as te
from sparsifyme_tpu_torch.ops import prune as tprune
from sparsifyme_tpu_torch.ops import sparse24 as ts
from sparsifyme_tpu_torch.utils import shapes as tsh
from sparsifyme_tpu_torch.utils.timing import time_kernel, time_kernel_pair

ROOT = pathlib.Path(__file__).resolve().parents[1]
BENCH_KEYS = {
    "metric", "value", "unit", "vs_baseline", "spmm24_speedup_geomean",
    "ell_speedup_geomean", "best_sparse_speedup_geomean",
    "spmm24_tflops_geomean", "ell_tflops_geomean", "gemm_tflops_geomean",
    "sol_speedup_geomean", "spmm24_frac_sol_geomean", "ell_frac_sol_geomean",
    "fused_frac_sol_geomean", "pair_spread_max", "pair_spread_worst",
}


@pytest.mark.parametrize("model", ["resnet18", "resnet34", "resnet50",
                                   "resnet101", "resnet152"])
def test_resnet_shapes_match_jax_and_datasets(model):
    got = tshapes.resnet_conv_shapes(model)
    assert [tuple(s) for s in got] == [
        tuple(s) for s in jshapes.resnet_conv_shapes(model)]
    csv_rows = tsh.read_shapes(str(ROOT / "datasets" / f"{model}.csv"))
    assert [tuple(s) for s in got] == [tuple(s) for s in csv_rows]
    assert tshapes.resnet_conv_shapes(model, include_maxpool=True) == [
        tsh.LayerShape(*s) for s in jshapes.resnet_conv_shapes(
            model, include_maxpool=True)]


def test_benchmark_shapes_and_csv_round_trip(tmp_path):
    shapes = tshapes.benchmark_shapes()
    assert len(shapes) == 49 and len(set(shapes)) == 17
    assert shapes[0].flops == 2 * 12544 * 64 * 147 * 32
    path = str(tmp_path / "s.csv")
    tsh.write_shapes(path, shapes)
    assert tsh.read_shapes(path) == shapes
    assert tsh.read_shapes("m,n,k,b\n1,2,3,4\n") == [tsh.LayerShape(1, 2, 3,
                                                                    4)]


def test_sweep_and_summary_on_cpu(tmp_path):
    shapes = [tsh.LayerShape(64, 32, 147, 2), tsh.LayerShape(196, 16, 64, 1),
              tsh.LayerShape(64, 32, 147, 2)]
    results = harness.sweep(shapes, iters=1, reps=1, device="cpu",
                            verbose=False)
    assert [r.layer for r in results] == [0, 1, 2]
    assert results[0].gemm_ms == results[2].gemm_ms  # deduplicated
    for r in results:
        for f in ("gemm_ms", "prune_ms", "compress_ms", "fused_ms",
                  "spmm24_ms", "ell_ms", "spmm24_speedup", "ell_speedup",
                  "sol24_ms", "fused_sol_ms", "fused_frac_sol"):
            assert getattr(r, f) > 0, f
        assert r.fused_sol_ms == r.compress_sol_ms
        assert math.isfinite(r.fused_ms) and math.isfinite(r.fused_frac_sol)
    summary = harness.summarize(results)
    line = harness.headline("tiny", summary, "CPU surface check")
    assert set(line) == BENCH_KEYS
    assert line["fused_frac_sol_geomean"] is not None  # rounded: tiny on CPU
    assert summary["fused_frac_sol_geomean"] > 0
    assert math.isfinite(summary["fused_ms_geomean"])
    assert line["best_sparse_speedup_geomean"] > 0
    json.dumps(line)
    harness.write_csv(str(tmp_path / "r.csv"), results)
    harness.write_compare_csv(str(tmp_path / "c.csv"), results)
    with open(tmp_path / "c.csv") as f:
        rows = list(csv.reader(f))
    assert rows[0] == ["layer", "m", "n", "k", "b", "gemm", "prune", "spmm",
                       "spmm24"]
    assert float(rows[1][7]) == results[0].ell_ms


@pytest.mark.parametrize("k,expand", [(147, True), (512, False)])
def test_ell_race_adds_expand_below_k512(monkeypatch, k, expand):
    """As in the JAX harness: layers with k < 512 race the expand kernel in
    both output layouts beside the two gather candidates."""
    calls = []
    real = harness.ell_expand_spmm_plain

    def spy(*args, **kw):
        calls.append(kw["transpose_out"])
        return real(*args, **kw)

    monkeypatch.setattr(harness, "ell_expand_spmm_plain", spy)
    out = harness.bench_shape(tsh.LayerShape(128, 16, k, 1), kernels=("ell",),
                              iters=1, reps=1, device="cpu")
    assert out["ell_ms"] > 0
    assert sorted(set(calls)) == ([False, True] if expand else [])


def test_entry_points_default_to_the_gpu():
    if torch.cuda.is_available():
        out = harness.bench_shape(tsh.LayerShape(8, 8, 8, 1), iters=1,
                                  reps=1)
        assert out["gemm_ms"] > 0
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        harness.bench_shape(tsh.LayerShape(8, 8, 8, 1))


def test_build_ell_operand_geometry():
    a = torch.randn(2, 100, 147)
    e, kp = harness.build_ell_operand(a, block_size=128, block_k=32,
                                      fold_first=True)
    assert kp == 192 and e.shape == (256, 192) and e.ell_blocks == 3
    e, kp = harness.build_ell_operand(a, block_size=128, block_k=32,
                                      fold_first=False)
    assert e.shape == (2, 128, 192)


def test_roofline_h100_bounds():
    mc = roofline.H100
    assert (mc.dense_tflops, mc.sparse24_tflops, mc.hbm_gbps) == (
        989.0, 1979.0, 3350.0)
    m, n, k, b = 3136, 128, 1152, 32
    rows = m * b
    byts = 2.0 * rows * k + 2.0 * k * n + 2.0 * rows * n
    assert roofline.dense_sol_ms(m, n, k, b) == pytest.approx(
        max(2.0 * rows * k * n / 989e12, byts / 3350e9) * 1e3)
    assert roofline.prune_sol_ms(m, k, b) == pytest.approx(
        6.0 * rows * k / 3350e9 * 1e3)
    assert roofline.compress_sol_ms(m, k, b) == pytest.approx(
        3.25 * rows * k / 3350e9 * 1e3)
    assert roofline.fused_sol_ms(m, k, b) == roofline.compress_sol_ms(m, k, b)
    assert roofline.ell_sol_ms(m, n, k, b) < roofline.dense_sol_ms(m, n, k, b)
    assert roofline.bound_by(1e12, 989.0, 1e3) == "operations"
    assert roofline.bound_by(1.0, 989.0, 1e9) == "bytes"


def test_timing_on_cpu():
    x = torch.randn(64, 64)
    t = time_kernel(torch.matmul, (x, x), iters=2, reps=3)
    assert t.ms > 0 and t.ms_min <= t.ms and t.reps == 3
    p = time_kernel_pair(torch.matmul, (x, x), torch.add, (x, x), iters=2,
                         reps=3)
    assert p.ratio > 0 and p.ratio_spread >= 1.0


@pytest.mark.parametrize("jdt,tdt,tol", [
    (jnp.float32, torch.float32, 1e-5),
    (jnp.bfloat16, torch.bfloat16, 2e-2),
])
def test_slice_end_to_end_matches_jax(rng, jdt, tdt, tol):
    """One seeded dense ``a`` and ``b`` through both formats in both
    packages: the same masks, planes and packing, and products within the
    stated tolerance."""
    a = np.asarray(jnp.asarray(rng.normal(size=(2, 64, 192)), jdt))
    b = np.asarray(jnp.asarray(rng.normal(size=(192, 32)), jdt))
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    ta, tb = tensor_from_numpy(a, "cpu"), tensor_from_numpy(b, "cpu")

    jp, jm = jprune.prune_nm(ja, 2, 4)
    tp, tm = tprune.prune_nm(ta, 2, 4)
    assert np.array_equal(np.asarray(jm, np.float32), tensor_to_numpy(tm))
    s, q = js.compress_24(jp), ts.compress_24(tp)
    assert np.array_equal(np.asarray(s.codes), tensor_to_numpy(q.codes))
    want24 = np.asarray(js.spmm_24(s, jb), np.float32)
    got24 = tensor_to_numpy(ts.spmm_24(q, tb))
    assert np.abs(got24 - want24).max() / np.abs(want24).max() < tol

    e, f = je.ell_from_dense(ja, 32, 3, 32), te.ell_from_dense(ta, 32, 3, 32)
    assert np.array_equal(np.asarray(e.col_indices),
                          tensor_to_numpy(f.col_indices))
    assert np.array_equal(np.asarray(e.values, np.float32),
                          tensor_to_numpy(f.values))
    want_e = np.asarray(je.spmm_ell(e, jb, interpret=True), np.float32)
    got_e = tensor_to_numpy(te.spmm_ell(f, tb))
    assert np.abs(got_e - want_e).max() / np.abs(want_e).max() < tol
    want_x = np.asarray(je.spmm_ell_expand(e, jb, interpret=True),
                        np.float32)
    got_x = tensor_to_numpy(te.spmm_ell_expand(f, tb))
    assert np.abs(got_x - want_x).max() / np.abs(want_x).max() < tol

    # The plan path: spmma's fused prune+compress and the fold=2 route.
    want_p = np.asarray(jplan.spmma(ja, jb), np.float32)
    got_p = tensor_to_numpy(tplan.spmma(ta, tb))
    assert got_p.shape == want_p.shape == (2, 64, 32)
    assert np.abs(got_p - want_p).max() / np.abs(want_p).max() < tol
    sf, qf = js.prune_compress_24(ja, fold=2), ts.prune_compress_24(ta,
                                                                    fold=2)
    assert np.array_equal(np.asarray(sf.codes), tensor_to_numpy(qf.codes))
    want_f = np.asarray(js.spmm_24(sf, jb), np.float32)
    got_f = tensor_to_numpy(ts.spmm_24(qf, tb))
    assert np.abs(got_f - want_f).max() / np.abs(want_f).max() < tol
