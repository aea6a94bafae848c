"""The port's ``shape_roofline`` and ``measure_machine`` beside the JAX
package's (``sparsifyme_tpu/bench/roofline.py``).

The two packages bound different machines (the JAX one a TPU, the port
an H100's data sheet), so ``shape_roofline`` is held to the JAX function's
keys and to its own bounds, and ``measure_machine`` runs on the CPU at a
small size, where only its rates' being finite and positive means
anything.
"""

import inspect
import math

import pytest

from sparsifyme_tpu.bench import roofline as jrl
from sparsifyme_tpu_torch.bench import roofline as trl

SHAPES = [(3136, 128, 1152, 32), (12544, 256, 64, 32), (196, 512, 4608, 32),
          (7, 8, 64, 1)]


@pytest.mark.parametrize("m,n,k,b", SHAPES)
def test_shape_roofline_has_the_jax_keys(m, n, k, b):
    got = trl.shape_roofline(m, n, k, b)
    assert list(got) == list(jrl.shape_roofline(m, n, k, b))
    assert got["dense_sol_ms"] == trl.dense_sol_ms(m, n, k, b)
    assert got["spmm24_sol_ms"] == trl.spmm24_sol_ms(m, n, k, b)
    assert got["ell_sol_ms"] == trl.ell_sol_ms(m, n, k, b)
    assert got["spmm24_sol_speedup"] == pytest.approx(
        got["dense_sol_ms"] / got["spmm24_sol_ms"])
    assert got["ell_sol_speedup"] == pytest.approx(
        got["dense_sol_ms"] / got["ell_sol_ms"])


def test_h100_stays_the_default_machine():
    for fn in (trl.shape_roofline, trl.dense_sol_ms, trl.spmm24_sol_ms,
               trl.ell_sol_ms, trl.prune_sol_ms, trl.compress_sol_ms):
        assert inspect.signature(fn).parameters["mc"].default is trl.H100
    half = trl.Machine(dense_tflops=494.5, sparse24_tflops=989.5,
                       hbm_gbps=1675.0, f32_tflops=33.5)
    m, n, k, b = SHAPES[0]
    assert trl.shape_roofline(m, n, k, b, half)["dense_sol_ms"] == \
        pytest.approx(2 * trl.shape_roofline(m, n, k, b)["dense_sol_ms"])


def test_measure_machine_on_the_cpu_gives_finite_positive_rates():
    mc = trl.measure_machine(device="cpu", n=64, copy_n=256)
    for rate in (mc.dense_tflops, mc.hbm_gbps, mc.f32_tflops):
        assert math.isfinite(rate) and rate > 0
    assert mc.sparse24_tflops == trl.H100.sparse24_tflops  # not measured
    report = trl.machine_report(mc)
    assert report["sparse24_tflops"] == {
        "measured": "not measured", "data_sheet": 1979.0, "share": None}
    assert report["hbm_gbps"]["share"] == pytest.approx(mc.hbm_gbps / 3350.0)


def test_measure_machine_needs_a_card_by_default(monkeypatch):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trl.measure_machine()
