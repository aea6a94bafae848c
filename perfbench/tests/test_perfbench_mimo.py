"""The MiMo-V2-Flash cell: its configuration's cut (published copied,
exactly the eight keys of one card's share reduced, no width), its files
found by name, and its route run through the harness on the CPU at a
small size (the configuration's keys and the traffic's lengths cut in a
copy of the benchmark), plain and traced."""

import json
import shutil

import pytest

from perfbench import faults, harness, routes
from perfbench.model_routes import mimo24
from perfbench.tests.test_perfbench_files import BENCH, model_config_faults
from perfbench.tests.tiny import SEED, tiny_job

ROOT = harness.ROOT
CELL = "mimo-v2-flash-ep8.prefill32k"
CONFIG = ROOT / "perfbench/configs/mimo-v2-flash-ep8.json"
CUT = ["num_hidden_layers", "hybrid_layer_pattern", "moe_layer_freq",
       "n_routed_experts", "num_attention_heads", "num_key_value_heads",
       "swa_num_attention_heads", "swa_num_key_value_heads"]
READ = {"mimo_mfu", "expert_roofline", "moe_route_ms", "moe_host_us",
        "proj24_roofline", "enqueue_ms", "idle_share", "dispatch_us", "launch_us",
        "sparse_speedup"}
# the CPU's sizes, merged over the configuration's keys
SMALL = {"hidden_size": 256, "intermediate_size": 512,
         "moe_intermediate_size": 128, "vocab_size": 512,
         "num_hidden_layers": 7,
         "hybrid_layer_pattern": [0, 1, 1, 1, 1, 0, 1],
         "moe_layer_freq": [0, 1, 1, 1, 1, 1, 1], "head_dim": 48,
         "v_head_dim": 32, "swa_head_dim": 48, "swa_v_head_dim": 32,
         "num_attention_heads": 4, "swa_num_attention_heads": 4,
         "n_routed_experts": 4, "num_experts_per_tok": 4,
         "sliding_window": 16, "published": {"n_routed_experts": 16}}


def test_the_cut_is_one_cards_share_and_no_width():
    data = json.loads(CONFIG.read_text())
    assert model_config_faults(data) == []
    assert data["reduced"] == CUT
    pub = data["published"]
    assert (pub["num_hidden_layers"], pub["n_routed_experts"],
            pub["num_attention_heads"], pub["swa_num_key_value_heads"]) == (
        48, 256, 64, 8)
    assert (data["num_hidden_layers"], data["n_routed_experts"],
            data["num_attention_heads"], data["num_key_value_heads"]) == (
        13, 32, 8, 1)
    assert data["hybrid_layer_pattern"] == pub["hybrid_layer_pattern"][:13]
    assert data["moe_layer_freq"] == pub["moe_layer_freq"][:13]
    for key in ("hidden_size", "intermediate_size", "moe_intermediate_size",
                "head_dim", "v_head_dim", "num_experts_per_tok",
                "vocab_size", "sliding_window"):
        assert data[key] == pub[key], key
    listed = {c["name"]: c for c in BENCH["configs"]}[data["name"]]
    assert listed["reduced"] == CUT and listed["source"] == data["source"]


def test_the_cell_finds_its_files():
    cell = harness.load_cell(CELL)
    assert cell.chips == 1 and cell.layers == []
    route = routes.resolve(cell.traffic["route"], cell.root)
    assert route.__name__ == "Mimo24" and route.dense_baseline
    assert {m["name"] for m in cell.per_layer} == READ
    for m in cell.per_layer:
        assert callable(harness.metric_reader(cell, m["name"]))
    t = cell.traffic
    assert t["sequences"] * t["seq_len"] == 32768


@pytest.fixture
def small_root(tmp_path):
    """A copy of the benchmark whose traffic runs 2 sequences of 64."""
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "perfbench", root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    path = root / "perfbench/traffic/prefill32k.json"
    traffic = json.loads(path.read_text())
    traffic.update(sequences=2, seq_len=64, dense_seconds=0.05)
    path.write_text(json.dumps(traffic))
    return root


def _line(root, trace):
    job = tiny_job(CELL, root, layers=None, config=SMALL, trace=trace)
    ranks = harness.run_job(job)[0]
    cell = harness.job_cell(job)
    return harness.result_line(cell, ranks, trace, "cpu", "cpu"), ranks


def test_the_cell_runs_small_on_the_cpu(small_root):
    line, ranks = _line(small_root, False)
    assert line["correct"] is True, line["checks"]
    assert set(line["metrics"]) == {"pass_ms", "pass_p95_ms",
                                    "peak_mem_gib", "setup_s"}
    assert any(d.endswith("wgmma_sp") for d in ranks[0]["designs"])


def test_a_traced_run_reads_the_model_metrics(small_root):
    from sparsifyme_tpu_torch.utils import trace
    trace.reset()
    line, ranks = _line(small_root, True)
    assert line["correct"] is True
    spans = ranks[0]["trace"]["spans"]
    passes = json.loads((small_root / "perfbench/traffic/prefill32k.json")
                        .read_text())["trace_passes"]
    assert spans["perfbench.experts"]["count"] == 6 * passes
    assert spans["perfbench.attention"]["count"] == 7 * passes
    assert spans["perfbench.dense_ffn"]["count"] == passes
    # q, k, v; o in every layer; the dense layer's gate_up; down
    assert spans["perfbench.proj24"]["count"] == (2 * 7 + 2) * passes
    got = line["metrics"]
    # the CPU has no device time: the device readings find nothing
    assert {"mimo_mfu", "moe_host_us", "enqueue_ms", "dispatch_us",
            "sparse_speedup"} <= set(got)
    assert not {"expert_roofline", "moe_route_ms", "idle_share",
                "proj24_roofline"} & set(got)
    assert 0 < got["mimo_mfu"]["value"] < 100
    assert got["moe_host_us"]["value"] > 0
    assert trace.summary()["counters"]["moe.rows"] > 0
    trace.reset()


@pytest.mark.parametrize("fault", faults.FAULTS)
def test_a_fault_in_the_expert_layer_reads_not_correct(small_root, fault):
    """Each planted fault (perfbench/faults.py) of one layer, one expert,
    half the rows or the router's bias reads not correct."""
    with faults.planted(fault, 6):
        line, _ = _line(small_root, False)
    assert line["correct"] is False, (fault, line["checks"])


def test_the_route_counts_the_models_work():
    route = routes.resolve("mimo24", ROOT)
    config = json.loads(CONFIG.read_text())
    traffic = harness.load_cell(CELL).traffic
    flops = route.pass_flops(config, traffic)
    t, hid = 32768, 4096
    # kept 2:4 products 21.5 TFLOP a pass; of the whole pass's work the
    # experts are 42%, the dense FFN 28%, the projections 21%
    experts = 12 * route.expert_flops(config, t * 8 * 32 / 256)
    projections = 13 * t * hid * (8 * 192 + 192 + 128 + 8 * 128)
    dense = t * 3 * 16384 * hid
    kept = experts + projections + dense
    assert 21.4e12 < kept < 21.6e12
    assert 23.4e12 < flops < 23.9e12  # router, attention core, head
    for part, share in ((experts, 0.42), (dense, 0.28), (projections, 0.21)):
        assert abs(part / flops - share) < 0.005
    assert route.expert_bytes(config, 0, 1) == 32 * 3 * 2048 * hid * 1.125


def test_the_flip_reader_counts_differing_choices(small_root):
    import torch

    from perfbench import flips
    got = torch.tensor([[0, 1], [2, 3], [4, 5], [6, 7]])
    want = torch.tensor([[1, 0], [2, 9], [4, 8], [6, 7]])
    # rows 1 and 2 differ; of held experts {3, 5}, both rows' differ
    assert flips.choices_differ(got, want, [3, 5]) == (0.5, 0.5)
    assert flips.choices_differ(got, want, [9]) == (0.5, 0.25)
    cell = harness.job_cell(tiny_job(CELL, small_root, layers=None,
                                     config=SMALL))
    row = flips.seed_flips(cell, SEED, torch.device("cpu"))
    assert len(row["by_layer"]) == len(row["same_input_by_layer"]) == 6
    assert 0 <= row["flip_share_held"] <= row["flip_share"] < 0.1
    assert 0 <= row["same_input_share"] <= row["flip_share"]
    assert row["same_input_violation"] < mimo24.TIE
    assert row["own_choice_readings"][0][0] < 0.1
