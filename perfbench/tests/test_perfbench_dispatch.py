"""The readers of the program's own spans (``dispatch_us``,
``launch_us``) and the benchmark's trace reader beside them: a CPU chrome
trace reads the same with the program's spans merged in, the readers
find the traced passes' calls in a tiny CPU run, and read nothing on
several ranks."""

import json
from types import SimpleNamespace

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from perfbench import harness, tracing
from perfbench.tests.tiny import tiny_cell, tiny_job
from sparsifyme_tpu_torch.ops import prune, sparse24
from sparsifyme_tpu_torch.utils import trace

ONE_CHIP = ["resnet50-b32.static24", "resnet152-b32.pipeline24",
            "resnet50-b32.ell50"]
READERS = ("dispatch_us", "launch_us")


@pytest.fixture(autouse=True)
def fresh_recorder():
    trace.reset()  # the pytest process holds the recorder across tests
    yield
    trace.reset()


def test_merged_program_spans_leave_the_trace_summary_unchanged(tmp_path):
    g = torch.Generator().manual_seed(0)
    a = torch.randn(128, 64, generator=g).to(torch.bfloat16)
    b = torch.randn(64, 64, generator=g).to(torch.bfloat16)
    s = sparse24.pack_wg(sparse24.compress_24(prune.prune_nm(a)[0]))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(tracing.WINDOW):
            for _ in range(3):
                with record_function("perfbench.spmm24"):
                    sparse24.spmm_24(s, b, out_dtype=torch.bfloat16)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    data = json.loads(path.read_text())
    events = data["traceEvents"]
    mine = trace.chrome_events(int(data["baseTimeNanoseconds"]))
    assert [ev["name"] for ev in mine].count("sparsifyme.spmm_24") == 3
    plain = tracing.summarize(events)
    merged = tracing.summarize(events + mine)
    assert plain["window_s"] > 0
    assert plain["spans"]["perfbench.spmm24"]["count"] == 3
    for key in ("spans", "device_ops", "idle_gaps", "window_s", "busy_s"):
        assert merged[key] == plain[key], key


@pytest.mark.parametrize("workload", ONE_CHIP)
def test_the_readers_find_the_traced_calls(workload):
    cell = tiny_cell(workload)
    ranks = harness.run_job(tiny_job(workload, trace=True))[0]
    view = harness.reader_view(cell, ranks)
    got = {name: harness.metric_reader(cell, name)(view) for name in READERS}
    assert got["dispatch_us"] is not None and got["dispatch_us"] > 0
    assert got["launch_us"] is None  # the plain versions launch nothing
    spans = trace.summary()["spans"]
    calls = sum(spans.get("sparsifyme." + e, {}).get("count", 0)
                for e in ("spmm_24", "spmm_ell", "prune_compress_24",
                          "pack_wg"))
    passes = cell.traffic["trace_passes"]
    per_layer = 3 if workload.endswith("pipeline24") else 1
    assert calls == passes * len(cell.layers) * per_layer
    line = harness.result_line(cell, ranks, True, "cpu", "cpu")
    assert "dispatch_us" in line["metrics"]
    assert "launch_us" not in line["metrics"]


def test_the_readers_read_nothing_on_several_ranks():
    cell = tiny_cell(ONE_CHIP[0])
    with trace.recording():
        trace.end(trace.begin("sparsifyme.spmm_24", "launch"))
    view = SimpleNamespace(world=4)
    for name in READERS:
        assert harness.metric_reader(cell, name)(view) is None
    view = SimpleNamespace(world=1)
    for name in READERS:
        assert harness.metric_reader(cell, name)(view) is not None


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ONE_CHIP)
def test_the_readers_read_a_traced_card_run(workload, card):
    cell = tiny_cell(workload)
    ranks = harness.run_job(tiny_job(workload, trace=True,
                                     device="cuda"))[0]
    view = harness.reader_view(cell, ranks)
    for name in READERS:
        got = harness.metric_reader(cell, name)(view)
        assert got is not None and got > 0, name
    counters = trace.summary()["counters"]
    assert counters.get("plan_miss", 0) == 0  # planned in the warm-up
