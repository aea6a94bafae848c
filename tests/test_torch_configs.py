"""The port's bench surface on the CPU: the drivers' stdout contracts (as
``tests/test_drivers.py`` holds the JAX drivers to them), the BASELINE
configs' result keys against the JAX runners' at one tiny shape (config 4
quick on 8 CPU ranks), the COO crossover locator against JAX's, and the K6
bound.

The JAX runners' timers are stubbed out: only their keys are compared,
and timing a tiny shape in interpret mode would cost seconds each.
"""

import io
import json
import math
from contextlib import redirect_stdout

import pytest

from sparsifyme_tpu import plan as jplan
from sparsifyme_tpu.bench import configs as jconfigs
from sparsifyme_tpu.utils import timing as jtiming
from sparsifyme_tpu.utils.shapes import LayerShape as JLayerShape
from sparsifyme_tpu_torch.bench import configs, drivers, roofline
from sparsifyme_tpu_torch.utils.shapes import LayerShape

TINY = (32, 8, 64, 4)  # m, n, k, b; b divisible by config 2's chunk of 4


def _capture(fn, *args, **kw):
    buf = io.StringIO()
    with redirect_stdout(buf):
        fn(*args, **kw)
    return buf.getvalue().strip().splitlines()


@pytest.mark.parametrize("kernel", ["gemm", "spmm", "batched_coo"])
def test_single_float_contract(kernel):
    lines = _capture(drivers.run, kernel, 32, 16, 64, 2, device="cpu")
    assert len(lines) == 1
    assert float(lines[0]) >= 0.0


def test_sparsify_contract():
    lines = _capture(drivers.run, "sparsify", 32, 64, device="cpu")
    assert len(lines) == 1
    assert float(lines[0]) >= 0.0


def test_spmma_three_phase_contract():
    lines = _capture(drivers.run, "spmma", 32, 16, 64, 2, device="cpu")
    assert [ln.split(":")[0] for ln in lines] == [
        "Prune time", "Compress time", "Matmul time"]
    for ln in lines:
        assert float(ln.split(":")[1]) >= 0.0


def test_main_argv():
    with pytest.raises(SystemExit):
        drivers.main(["gemm"])  # wrong arity
    with pytest.raises(SystemExit):
        drivers.main(["gemm", "16", "16", "32", "--cpu"])
    with pytest.raises(SystemExit, match="unknown kernel"):
        drivers.main(["conv", "16", "16", "--cpu"])
    lines = _capture(drivers.main, ["gemm", "16", "16", "32", "2", "--cpu"])
    assert len(lines) == 1 and float(lines[0]) >= 0.0


@pytest.fixture
def tiny(monkeypatch):
    """Both packages' configs see one tiny shape; the JAX timers return a
    constant."""
    monkeypatch.setattr(configs, "resnet_conv_shapes",
                        lambda name: [LayerShape(*TINY)])
    monkeypatch.setattr(jconfigs, "resnet_conv_shapes",
                        lambda name: [JLayerShape(*TINY)])

    def stub(fn, operands, **kw):
        return jtiming.Timing(ms=1.0, ms_min=1.0, iters=1, reps=1)

    monkeypatch.setattr(jconfigs, "time_kernel", stub)
    monkeypatch.setattr(jplan, "time_kernel", stub)


def _keys(result):
    rows = result.get("rows") or [{}]
    return sorted(result), sorted(rows[0])


@pytest.mark.parametrize("config", [0, 2, 3])
def test_configs_keep_the_jax_keys(tiny, config):
    got = configs.RUNNERS[config](device="cpu")
    want = jconfigs.RUNNERS[config]()
    assert _keys(got) == _keys(want)
    assert got["config"] == config and got["backend"] == "cpu"
    json.dumps(got, default=float)
    if config == 2:
        assert got["points"] == len(got["rows"]) == 6
        assert sorted(got["crossover_by_shape"]) == sorted(
            want["crossover_by_shape"]) == ["x".join(map(str, TINY))]
        for r in got["rows"]:
            assert r["coo_seg_ms"] > 0 and r["coo_xla_ms"] > 0
            assert math.isnan(r["coo_seg_slices_ms"])
            assert r["conversion_ms"] > 0 and r["nnz_per_s"] > 0


def test_config2_main_prints_one_json_line(tiny):
    lines = _capture(configs.main, ["2", "--quick", "--cpu"])
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert out["config"] == 2 and out["points"] == 6


# The keys of the JAX config 4 runner
# (sparsifyme_tpu/bench/configs.py:369-380,447-478). Its live run interprets
# both Pallas rings with race detection, too slow for this suite, so the
# keys are written here and checked against its source.
CONFIG4_KEYS = {
    "top": ["config", "backend", "shape", "emulated_headline", "points",
            "explicit_overlap_ring", "tiled_ring", "note"],
    "shape": ["b_per_device", "m", "n", "k"],
    "point": ["devices", "batch", "ring_ms", "ideal_ms", "comm_efficiency",
              "nnz_per_s_per_device", "halo_bytes_per_device",
              "weak_scaling_throughput_ratio"],
    "emulated_headline": ["what", "devices", "comm_efficiency",
                          "comm_efficiency_raw", "note"],
    "explicit_overlap_ring": ["kernel", "devices", "max_rel_err_vs_ppermute",
                              "race_detection"],
    "tiled_ring": ["kernel", "devices", "m_tiles_per_shard",
                   "max_rel_err_vs_ppermute"],
}


@pytest.fixture(scope="module")
def config4_lines():
    """``main(["4", "--quick", "--cpu"])``: config 4 quick on 8 CPU ranks."""
    return _capture(configs.main, ["4", "--quick", "--cpu"])


def test_config4_keeps_the_jax_keys(config4_lines):
    import inspect

    src = inspect.getsource(jconfigs.config4_row_partitioned_scaling)
    for keys in CONFIG4_KEYS.values():
        for key in keys:
            assert f'"{key}"' in src, key
    got = json.loads(config4_lines[0])
    assert sorted(got) == sorted(CONFIG4_KEYS["top"])
    for part in ("shape", "emulated_headline", "explicit_overlap_ring",
                 "tiled_ring"):
        assert sorted(got[part]) == sorted(CONFIG4_KEYS[part]), part
    assert [pt["devices"] for pt in got["points"]] == [1, 2, 4, 8]
    for pt in got["points"]:  # plus the port's "cards"
        assert sorted(pt) == sorted(CONFIG4_KEYS["point"] + ["cards"])
        assert pt["cards"] == 1 and pt["ring_ms"] > 0 and pt["ideal_ms"] > 0
        assert pt["batch"] == 2 * pt["devices"]
    assert got["points"][2]["halo_bytes_per_device"] == 3 * 128 * 128 * 4
    for ring in ("explicit_overlap_ring", "tiled_ring"):
        assert got[ring]["devices"] == 4
        assert got[ring]["max_rel_err_vs_ppermute"] < 1e-4
    assert got["explicit_overlap_ring"]["race_detection"] is False


def test_config4_main_prints_one_json_line(config4_lines):
    assert len(config4_lines) == 1
    out = json.loads(config4_lines[0])
    assert out["config"] == 4 and out["backend"] == "cpu"
    assert out["shape"] == {"b_per_device": 2, "m": 256, "n": 128, "k": 512}


def _crossover_rows(ko_ic):
    return [{"m": 1, "n": 2, "k": 3, "b": 4, "sparsity": sp,
             "speedup_vs_dense": ko, "speedup_vs_dense_incl_conv": ic}
            for sp, ko, ic in ko_ic]


@pytest.mark.parametrize("points", [
    [(0.9, 0.5, 0.2), (0.99, 2.0, 0.8), (0.995, 4.0, 1.6)],  # bracketed
    [(0.9, 0.1, 0.05), (0.99, 0.1, 0.05), (0.995, 0.1, 0.05)],  # never
    [(0.5, 1.5, 1.2), (0.9, 3.0, 2.0)],  # winning from the first point
    [(0.5, 0.01, 0.005), (0.9, 0.1, 0.05)],  # extrapolated
    [(0.5, 0.2, float("nan")), (0.7, 0.6, 0.1), (0.9, 1.4, 0.3)],
])
def test_coo_crossovers_match_jax(points):
    rows = _crossover_rows(points)
    got = configs._coo_crossovers([dict(r) for r in rows])
    assert got == jconfigs._coo_crossovers([dict(r) for r in rows])
    e = got["1x2x3x4"]
    if points[0][0] == 0.9 and points[1][1] == 2.0:
        assert 0.9 < e["speedup_vs_dense"] < 0.99
        assert 0.99 < e["speedup_vs_dense_incl_conv"] <= 0.995


def test_geomean_skips_nan_and_nonpositive():
    assert configs._geomean([1.0, 4.0, float("nan"), 0.0]) == 2.0
    assert math.isnan(configs._geomean([]))


def test_coo_spmm_bound():
    """The K6 bound at the kernels-line shape (3136x128x1152, b=32, 90%
    sparsity): the f32 operations bind, about 0.044 ms."""
    assert roofline.H100.f32_tflops == 67.0
    nnz, slots, m, k, n, b = 361267, 25 * 14592, 3136, 1152, 128, 32
    flops, byts = roofline.coo_spmm_work(nnz, slots, m, k, n, b)
    assert flops == 2.0 * nnz * b * n
    assert byts == 2.0 * b * k * n + 4.0 * b * m * n + 12.0 * slots
    assert flops / 67e12 * 1e3 == pytest.approx(0.044, abs=0.001)
    assert byts / 3350e9 * 1e3 == pytest.approx(0.020, abs=0.001)
    assert roofline.bound_by(flops, 67.0, byts) == "operations"


@pytest.mark.parametrize("point", range(3))
def test_coo_probe_forces_every_route_and_split(point):
    """The K6 probe's plan list at each kernels-line point (the first three
    of its points): both routes (only gather on a layout of wide chunks),
    every split count that leaves no split without chunks, each a plan
    ``coo_plan`` returns, and the plan K6 picks among them."""
    from sparsifyme_tpu_torch.bench import coo_probe
    from sparsifyme_tpu_torch.ops.kernels import coo_kernel as ck

    m, n, k, sp = coo_probe.POINTS[point]
    mb, b = -(-m // 128), coo_probe.BATCH
    nnz = int(m * k * (1 - sp))
    kc = ck.coo_kc(nnz, mb, 128, k)
    plans = coo_probe.plans(mb, 128, k, kc, nnz, b * n)
    n_chunks = -(-k // kc)
    splits = [s for s in range(1, ck.MAX_SPLITS + 1)
              if s <= n_chunks and (s - 1) * -(-n_chunks // s) < n_chunks]
    routes = coo_probe.ROUTES if kc <= 128 else ("gather",)  # no B tile
    assert sorted((p.route, p.splits) for p in plans) == sorted(
        (r, s) for r in routes for s in splits)
    assert ck.coo_plan(mb, 128, k, kc, nnz, b * n) in plans


def test_coo_probe_times_both_layouts_where_the_routes_are_close():
    """At 0.99 and 0.995 the probe times each route on a staged layout
    (chunks of 128 rows) and on the gather route's wide chunks, whichever
    the layout picks; below, the picked layout alone."""
    from sparsifyme_tpu_torch.bench import coo_probe
    from sparsifyme_tpu_torch.ops.kernels import coo_kernel as ck

    assert coo_probe.layout_kcs(32, 0.9) == [32]
    assert coo_probe.layout_kcs(128, 0.99) == [128, ck.GATHER_KC]
    assert coo_probe.layout_kcs(ck.GATHER_KC, 0.995) == [ck.GATHER_KC, 128]
    m, n, k, _ = coo_probe.POINTS[2]  # 0.995: both routes on 128-row chunks
    nnz = int(m * k * 0.005)
    routes = {p.route for p in coo_probe.plans(-(-m // 128), 128, k, 128,
                                               nnz, coo_probe.BATCH * n)}
    assert routes == {"staged", "gather"}


def test_coo_probe_times_each_route_on_its_own_layout():
    """``--routes``: at every shape and sparsity a staged plan on 128-row
    chunks and a gather plan on the gather route's wide chunks."""
    from sparsifyme_tpu_torch.bench import coo_probe
    from sparsifyme_tpu_torch.ops.kernels import coo_kernel as ck

    for m, n, k in coo_probe.ROUTE_SHAPES:
        for sp in coo_probe.ROUTE_SPARSITIES:
            mb = -(-m // 128)
            got = coo_probe.route_plans(mb, k, int(m * k * (1 - sp)),
                                        coo_probe.BATCH * n)
            assert [(kc, p.route) for kc, p in got] == [
                (128, "staged"), (ck.GATHER_KC, "gather")]


@pytest.mark.parametrize("src", ["coo_spmm", "compress24", "prune_nm"])
def test_coo_probe_ablations_find_their_code(src):
    """Each ablation of the probe edits text the kernel source still holds,
    and the probe's ctypes spec has one letter per parameter of the C entry
    point (as the wrappers pass them)."""
    import re

    from sparsifyme_tpu_torch import _build
    from sparsifyme_tpu_torch.bench import coo_probe

    text = (_build.CSRC / f"{src}.cu").read_text()
    entry, spec, builds = coo_probe.ABLATIONS[src]
    for edits in builds.values():
        for old, _ in edits:
            assert old in text
    params = re.search(r'extern "C" int ' + entry + r"\(([^)]*)\)", text)
    assert len(params.group(1).split(",")) == len(spec)
