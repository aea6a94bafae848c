"""The span recorder of ``sparsifyme_tpu_torch.utils.trace`` in the ops
dispatch: nothing recorded and no profiler range opened with recording
off; under a CPU profiler session and under ``trace.recording()`` each
public call's entry span and the phases that tile it, with parent links
and one call id; the buffer's bound; the spans on the profiler trace's
axis; ``profile_trace``'s merged file; the plan and loader counters.

The card tests at the end need a CUDA card and skip without one; on the
card: ``python -m pytest --noconftest tests/test_torch_trace.py -q -m
cuda``.
"""

import json
import os

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from sparsifyme_tpu_torch import _build
from sparsifyme_tpu_torch.bench import trace_cost
from sparsifyme_tpu_torch.ops import ell as ell_ops
from sparsifyme_tpu_torch.ops import prune, sparse24
from sparsifyme_tpu_torch.ops.kernels import ell_kernel, spmm24_kernel
from sparsifyme_tpu_torch.utils import trace

BF16 = torch.bfloat16
# the phases of each entry on CPU tensors, in order
CPU_PHASES = {
    "spmm_24": ["check_wg", "design", "plain"],
    "spmm_ell": ["prep", "plain"],
    "prune_compress_24": ["prep", "plain"],
    "pack_wg": ["prep", "plain", "bind"],
    "compress_24": ["prep", "plain"],
    "prune_nm": ["prep", "plain"],
}
ENTRIES = list(CPU_PHASES)


@pytest.fixture(autouse=True)
def fresh_recorder():
    trace.reset()
    yield
    trace.reset()


def _inputs(device="cpu"):
    g = torch.Generator().manual_seed(0)
    a = torch.randn(256, 128, generator=g).to(BF16).to(device)
    b = torch.randn(128, 64, generator=g).to(BF16).to(device)
    s = sparse24.compress_24(prune.prune_nm(a)[0])
    e = ell_ops.ell_from_dense(a, 128, 2, 32)
    return a, b, s, sparse24.pack_wg(s), e


def _call(entry, inputs):
    """One call of ``entry``; returns its result."""
    a, b, s, swg, e = inputs
    return {
        "spmm_24": lambda: sparse24.spmm_24(swg, b, out_dtype=BF16),
        "spmm_ell": lambda: ell_ops.spmm_ell(e, b),
        "prune_compress_24": lambda: sparse24.prune_compress_24(a),
        "pack_wg": lambda: sparse24.pack_wg(s),
        "compress_24": lambda: sparse24.compress_24(a),
        "prune_nm": lambda: prune.prune_nm(a),
    }[entry]()


def _events(base_ns=0):
    return trace.chrome_events(base_ns)


@pytest.mark.parametrize("entry", ENTRIES)
def test_nothing_is_recorded_with_recording_off(entry, monkeypatch):
    inputs = _inputs()

    def refuse(*a, **k):
        raise AssertionError("the program opened a profiler range")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda.nvtx, "range_push", refuse)
    _call(entry, inputs)
    got = trace.summary()
    assert got["spans"] == {} and got["calls"] == 0
    assert got["counters"] == {} and not trace._STACK


@pytest.mark.parametrize("entry", ENTRIES)
@pytest.mark.parametrize("mode", ["profiler", "recording"])
def test_each_call_records_its_entry_and_phases(entry, mode):
    inputs = _inputs()
    ctx = (profile(activities=[ProfilerActivity.CPU]) if mode == "profiler"
           else trace.recording())
    calls = 3
    with ctx:
        for _ in range(calls):
            _call(entry, inputs)
    name = "sparsifyme." + entry
    phases = [name + "." + p for p in CPU_PHASES[entry]]
    spans = trace.summary()["spans"]
    assert set(spans) == {name, *phases}
    assert all(spans[n]["count"] == calls for n in spans)
    # the phases tile the entry: it has no self time of its own
    assert spans[name]["self_us"] == pytest.approx(0.0, abs=1e-6)
    assert trace.summary()["calls"] == calls
    events = _events(min(_raw_starts()))
    entries = [ev for ev in events if ev["name"] == name]
    assert len({ev["args"]["call"] for ev in entries}) == calls
    for ev in entries:
        kids = sorted((k for k in events
                       if k["args"]["parent"] == ev["args"]["span"]),
                      key=lambda k: k["ts"])
        assert [k["name"] for k in kids] == phases
        assert {k["args"]["call"] for k in kids} == {ev["args"]["call"]}
        assert kids[0]["ts"] == pytest.approx(ev["ts"], abs=1e-3)
        for x, y in zip(kids, kids[1:]):
            assert x["ts"] + x["dur"] == pytest.approx(y["ts"], abs=1e-3)
        end = ev["ts"] + ev["dur"]
        assert kids[-1]["ts"] + kids[-1]["dur"] == pytest.approx(end,
                                                                 abs=1e-3)
    assert not trace._STACK


def _raw_starts():
    return [sp[1] for sp in trace._REC.spans]


def test_no_program_span_or_counter_is_the_benchmarks():
    inputs = _inputs()
    with trace.recording():
        for entry in ENTRIES:
            _call(entry, inputs)
        ell_kernel.ell_plan(384, 72, 3, 32, 128)  # a plan not yet cached
    got = trace.summary()
    assert got["spans"] and got["counters"]
    for name in list(got["spans"]) + list(got["counters"]):
        assert not name.startswith("perfbench."), name
    assert all(n.startswith("sparsifyme.") for n in got["spans"])


def test_the_buffer_drops_past_its_capacity_and_counts(monkeypatch):
    inputs = _inputs()
    monkeypatch.setattr(trace._REC, "capacity", 5)
    with trace.recording():
        _call("spmm_ell", inputs)  # entry, prep, plain: 3 spans
        _call("spmm_ell", inputs)  # 2 kept, 1 dropped
    got = trace.summary()
    assert got["dropped"] == 1 and len(trace._REC.spans) == 5
    assert got["spans"]["sparsifyme.spmm_ell"]["count"] == 2
    assert got["spans"]["sparsifyme.spmm_ell.prep"]["count"] == 2
    assert got["spans"]["sparsifyme.spmm_ell.plain"]["count"] == 1
    assert not trace._STACK


def test_an_entry_span_lies_inside_its_profiler_range(tmp_path):
    inputs = _inputs()
    _call("spmm_ell", inputs)  # warm
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("test.outer"):
            _call("spmm_ell", inputs)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    data = json.loads(path.read_text())
    outer = [ev for ev in data["traceEvents"]
             if ev.get("name") == "test.outer" and ev.get("ph") == "X"]
    assert len(outer) == 1
    ts, dur = float(outer[0]["ts"]), float(outer[0]["dur"])
    mine = [ev for ev in _events(int(data["baseTimeNanoseconds"]))
            if ev["name"] == "sparsifyme.spmm_ell"]
    assert len(mine) == 1
    s, e = mine[0]["ts"], mine[0]["ts"] + mine[0]["dur"]
    assert ts - 50 <= s and e <= ts + dur + 50, (ts, dur, s, e)


def test_profile_trace_writes_the_program_spans(tmp_path):
    inputs = _inputs()
    with trace.profile_trace(str(tmp_path)):
        _call("spmm_24", inputs)
    data = json.loads((tmp_path / trace.TRACE_FILE).read_text())
    mine = [ev for ev in data["traceEvents"]
            if ev.get("cat") == trace.CATEGORY]
    names = {ev["name"] for ev in mine}
    assert {"sparsifyme.spmm_24", "sparsifyme.spmm_24.check_wg",
            "sparsifyme.spmm_24.design", "sparsifyme.spmm_24.plain"} == names
    assert {ev["pid"] for ev in mine} == {os.getpid()}
    host = {(ev.get("pid"), ev.get("tid")) for ev in data["traceEvents"]
            if ev.get("cat") == "cpu_op"}
    assert {(ev["pid"], ev["tid"]) for ev in mine} <= host


def test_self_time_is_the_duration_less_the_children():
    with trace.recording():
        with trace.trace_range("sparsifyme.outer"):
            with trace.trace_range("sparsifyme.inner"):
                torch.ones(64).sum()
            torch.ones(64).sum()
    spans = trace.summary()["spans"]
    outer, inner = spans["sparsifyme.outer"], spans["sparsifyme.inner"]
    assert inner["self_us"] == pytest.approx(inner["total_us"])
    assert outer["self_us"] == pytest.approx(outer["total_us"]
                                             - inner["total_us"])
    assert trace.summary()["calls"] == 0  # spans outside any public call
    assert {ev["args"]["call"] for ev in _events()} == {0}


def test_an_exception_closes_the_call():
    inputs = _inputs()
    _, b, _, swg, _ = inputs
    with trace.recording():
        with pytest.raises(NotImplementedError):
            sparse24.spmm_24(swg, b, transpose_a=True)
    spans = trace.summary()["spans"]
    assert spans["sparsifyme.spmm_24"]["count"] == 1
    assert spans["sparsifyme.spmm_24.design"]["count"] == 1
    assert not trace._STACK


def test_plan_miss_counts_a_cache_miss_while_recording():
    args = (640, 88, 3, 64, 128)  # a shape no other test plans
    with trace.recording():
        ell_kernel.ell_plan(*args)
        ell_kernel.ell_plan(*args)
    assert trace.summary()["counters"] == {"plan_miss": 1}
    ell_kernel.ell_plan(640, 96, 3, 64, 128)  # recording off
    assert trace.summary()["counters"] == {"plan_miss": 1}


def test_kernel_load_and_build_are_spans_of_the_loader(monkeypatch,
                                                      tmp_path):
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "DEFAULT_NVCC", str(tmp_path / "nvcc"))
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(_build, "_entries", {})
    with trace.recording():
        with pytest.raises(_build.KernelBuildError):
            _build.load("spmm24", "spmm24_launch", "p")
    spans = trace.summary()["spans"]
    assert spans["sparsifyme.kernel_load"]["count"] == 1
    assert spans["sparsifyme.kernel_build"]["count"] == 1
    load, build = sorted(_events(), key=lambda ev: ev["ts"])
    assert build["args"]["parent"] == load["args"]["span"]
    assert not trace._STACK


def test_the_off_cost_benchmark_reads_both_sides():
    got = trace_cost.measure(n=200, reps=1)
    assert got["calls"] == 200 and got["spans_per_call"] == 7.0
    assert got["off_ns_per_call"] < got["on_ns_per_call"]
    assert trace.summary()["spans"] == {}


# --- on the card ------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


CARD_PHASES = {
    "spmm_24": ["check_wg", "design", "prep", "plan", "alloc", "launch"],
    "spmm_ell": ["prep", "plan", "alloc", "launch"],
    "pack_wg": ["prep", "alloc", "launch", "bind"],
}


@pytest.mark.cuda
@pytest.mark.parametrize("entry", list(CARD_PHASES))
def test_card_calls_record_plan_alloc_and_launch(card, entry):
    inputs = _inputs(card)
    _call(entry, inputs)
    torch.cuda.synchronize()
    trace.reset()
    with trace.recording():
        _call(entry, inputs)
    torch.cuda.synchronize()
    name = "sparsifyme." + entry
    spans = trace.summary()["spans"]
    assert set(spans) == {name} | {name + "." + p
                                   for p in CARD_PHASES[entry]}
    events = sorted((ev for ev in _events() if ev["name"] != name),
                    key=lambda ev: ev["ts"])
    assert [ev["name"] for ev in events] == [
        name + "." + p for p in CARD_PHASES[entry]]


@pytest.mark.cuda
@pytest.mark.parametrize("entry", ["spmm_24", "spmm_ell"])
def test_a_fresh_process_loads_and_plans_once(card, entry, monkeypatch):
    """With the loaded entry points and the plans forgotten, as in a new
    process, the first call records ``kernel_load`` and ``plan_miss`` and
    the second neither."""
    inputs = _inputs(card)
    monkeypatch.setattr(_build, "_entries", {})
    spmm24_kernel.card_wg_plan.cache_clear()
    ell_kernel.ell_plan.cache_clear()
    seen = []
    for _ in range(2):
        trace.reset()
        with trace.recording():
            _call(entry, inputs)
        torch.cuda.synchronize()
        seen.append(trace.summary())
    first, second = seen
    assert first["spans"]["sparsifyme.kernel_load"]["count"] == 1
    assert first["counters"]["plan_miss"] >= 1
    assert "sparsifyme.kernel_load" not in second["spans"]
    assert second["counters"] == {}
