"""The DeepSeek-V3 cell: its configuration's cut (published copied,
exactly the four keys of one card's TP4/EP32 share reduced, no width),
its files found by name, its route run through the harness on the CPU at
a small size (the configuration's keys and the traffic's lengths cut in a
copy of the benchmark), plain and traced, its five planted faults reading
not correct, and its readers and work counts."""

import json
import shutil
from types import SimpleNamespace

import pytest

from perfbench import faults_dsv3, flips_dsv3, harness, routes
from perfbench.model_routes import dsv3mla24
from perfbench.tests.test_perfbench_files import BENCH, model_config_faults
from perfbench.tests.tiny import SEED, tiny_job

ROOT = harness.ROOT
CELL = "deepseek-v3-ep32.mla-prefill32k"
CONFIG = ROOT / "perfbench/configs/deepseek-v3-ep32.json"
CUT = ["num_hidden_layers", "n_routed_experts", "num_attention_heads",
       "num_key_value_heads"]
NEW = {"dsv3_mfu", "mla_attention_ms", "shared_expert_roofline"}
REUSED = {"enqueue_ms", "idle_share", "sparse_speedup", "dispatch_us",
          "launch_us", "proj24_roofline", "expert_roofline", "moe_route_ms",
          "moe_host_us"}
# the CPU's sizes, merged over the configuration's keys: the published
# latents and head widths, so that the attention's scores spread as at
# full size; 2 of 8 heads, 4 held of 32 experts in 4 groups (2 kept)
SMALL = {"hidden_size": 256, "intermediate_size": 512,
         "moe_intermediate_size": 128, "vocab_size": 512,
         "num_hidden_layers": 5, "first_k_dense_replace": 2,
         "num_attention_heads": 2, "num_key_value_heads": 2,
         "n_routed_experts": 4, "num_experts_per_tok": 4, "n_group": 4,
         "topk_group": 2, "published": {"n_routed_experts": 32}}


def test_the_cut_is_one_cards_share_and_no_width():
    data = json.loads(CONFIG.read_text())
    assert model_config_faults(data) == []
    assert data["reduced"] == CUT
    pub = data["published"]
    assert (pub["num_hidden_layers"], pub["n_routed_experts"],
            pub["num_attention_heads"], pub["num_key_value_heads"]) == (
        61, 256, 128, 128)
    assert (data["num_hidden_layers"], data["n_routed_experts"],
            data["num_attention_heads"], data["num_key_value_heads"]) == (
        11, 8, 32, 32)
    for key in ("hidden_size", "intermediate_size", "moe_intermediate_size",
                "q_lora_rank", "kv_lora_rank", "qk_nope_head_dim",
                "qk_rope_head_dim", "v_head_dim", "num_experts_per_tok",
                "vocab_size", "n_group", "topk_group", "n_shared_experts",
                "routed_scaling_factor", "rope_scaling",
                "first_k_dense_replace", "moe_layer_freq", "rms_norm_eps"):
        assert data[key] == pub[key], key
    assert "TP4" in data["deployment"] and "EP32" in data["deployment"]
    assert any("experts 0-7" in a for a in data["assumed"])
    listed = {c["name"]: c for c in BENCH["configs"]}[data["name"]]
    assert listed["reduced"] == CUT and listed["source"] == data["source"]
    assert dsv3mla24.moe_layers(data) == list(range(3, 11))
    cfg = dsv3mla24.model_config(data)
    assert cfg.n_routed_experts == 256 and cfg.held_experts == tuple(
        range(8))
    # EP32's card holds a quarter of the router's first group
    assert 256 // cfg.n_group == 32


def test_the_cell_finds_its_files():
    cell = harness.load_cell(CELL)
    assert cell.chips == 1 and cell.layers == []
    route = routes.resolve(cell.traffic["route"], cell.root)
    assert route.__name__ == "Dsv3Mla24" and route.dense_baseline
    assert {m["name"] for m in cell.per_layer} == NEW | REUSED
    for m in cell.per_layer:
        assert callable(harness.metric_reader(cell, m["name"]))
    t = cell.traffic
    assert t["sequences"] * t["seq_len"] == 32768
    for m in BENCH["per_layer"]:
        if m["name"] in NEW:
            assert m["workloads"] == [CELL]


@pytest.fixture
def small_root(tmp_path):
    """A copy of the benchmark whose traffic runs 2 sequences of 64."""
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "perfbench", root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    path = root / "perfbench/traffic/mla-prefill32k.json"
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
    designs = ranks[0]["designs"]
    assert "kv_a mma_sp" in designs and "shared.down wgmma_sp" in designs


def test_a_traced_run_reads_the_model_metrics(small_root):
    from sparsifyme_tpu_torch.utils import trace
    trace.reset()
    line, ranks = _line(small_root, True)
    assert line["correct"] is True
    spans = ranks[0]["trace"]["spans"]
    passes = json.loads((small_root / "perfbench/traffic/mla-prefill32k.json")
                        .read_text())["trace_passes"]
    assert spans["perfbench.attention"]["count"] == 5 * passes
    assert spans["perfbench.dense_ffn"]["count"] == 2 * passes
    for stage in ("moe_route", "shared_expert", "experts", "moe_combine"):
        assert spans["perfbench." + stage]["count"] == 3 * passes, stage
    # q_a, kv_a; q_b, kv_b; o in every layer; the dense layers' gate_up;
    # down
    assert spans["perfbench.proj24"]["count"] == (3 * 5 + 2 * 2) * passes
    got = line["metrics"]
    # the CPU has no device time: the device readings find nothing
    assert {"dsv3_mfu", "moe_host_us", "enqueue_ms", "dispatch_us",
            "sparse_speedup"} <= set(got)
    assert not {"expert_roofline", "moe_route_ms", "idle_share",
                "proj24_roofline", "mla_attention_ms",
                "shared_expert_roofline"} & set(got)
    assert 0 < got["dsv3_mfu"]["value"] < 100
    summary = trace.summary()
    counters = summary["counters"]
    assert counters["moe.shared_rows"] % 128 == 0
    assert 0 < counters["moe.group_tokens"] <= counters["moe.shared_rows"]
    assert counters["moe.rows"] > 0
    for phase in ("q_latent", "kv_latent", "rope", "core", "out"):
        assert summary["spans"]["sparsifyme.mla." + phase]["count"] > 0
    assert summary["spans"]["sparsifyme.moe.shared"]["count"] > 0
    trace.reset()


def _traced_view(config, traffic, spans, pass_ms=400.0, passes=3):
    """What a reader gets from a traced run whose spans' device seconds
    are ``spans``."""
    trace = {"window_s": 1.0, "busy_s": 0.9,
             "spans": {"perfbench." + name: {"count": 3 * passes,
                                             "all_s": s}
                       for name, s in spans.items()}}
    return SimpleNamespace(config=config, traffic=traffic,
                           route=dsv3mla24.Dsv3Mla24, pass_ms=pass_ms,
                           traces=[trace], trace_passes=passes)


def test_the_new_readers_read_a_traced_pass():
    cell = harness.load_cell(CELL)
    view = _traced_view(cell.config, cell.traffic,
                        {"attention": 0.4, "shared_expert": 0.09})
    read = {m: harness.metric_reader(cell, m) for m in NEW}
    assert read["mla_attention_ms"](view) == pytest.approx(1e3 * 0.4 / 3)
    least = dsv3mla24.Dsv3Mla24.shared_least_s(cell.config, cell.traffic)
    assert read["shared_expert_roofline"](view) == pytest.approx(
        100 * 3 * least / 0.09)
    flops = dsv3mla24.Dsv3Mla24.pass_flops(cell.config, cell.traffic)
    assert read["dsv3_mfu"](view) == pytest.approx(
        100 * flops / (0.4 * 989e12), rel=1e-3)
    silent = _traced_view(cell.config, cell.traffic, {"attention": 0.0})
    assert read["mla_attention_ms"](silent) is None
    assert read["shared_expert_roofline"](silent) is None


@pytest.mark.parametrize("fault", faults_dsv3.FAULTS)
def test_a_planted_fault_reads_not_correct(small_root, fault):
    """Each planted fault (perfbench/faults_dsv3.py): the group limit, the
    shared expert or the routed scale left out, rotate-half in place of
    the interleaved pairs, YaRN's mscale left out of the softmax scale."""
    with faults_dsv3.planted(fault):
        line, _ = _line(small_root, False)
    assert line["correct"] is False, (fault, line["checks"])


def test_the_route_counts_the_models_work():
    route = routes.resolve("dsv3mla24", ROOT)
    config = json.loads(CONFIG.read_text())
    traffic = harness.load_cell(CELL).traffic
    t, hid = 32768, 7168
    mla = 11 * t * (1536 * hid + 6144 * 1536 + 576 * hid + 8192 * 512
                    + hid * 4096)
    core = 11 * 2 * 8 * 32 * (4096 * 4097 / 2) * (192 + 128)
    dense = 3 * t * 3 * 18432 * hid
    shared = 8 * t * 3 * 2048 * hid
    routed = 8 * route.expert_flops(config, t * 8 * 8 / 256)
    router = 8 * 2 * t * hid * 256
    for part, tflop in ((mla, 20.9), (core, 15.1), (dense, 39.0),
                        (shared, 11.5), (routed, 2.9), (router, 0.96)):
        assert part / 1e12 == pytest.approx(tflop, rel=0.01), tflop
    flops = route.pass_flops(config, traffic)
    head = 2 * 8 * hid * 129280
    assert flops == pytest.approx(mla + core + dense + shared + routed
                                  + router + head)
    assert 90.3e12 < flops < 90.5e12
    assert route.expert_bytes(config, 0, 1) == 8 * 3 * 2048 * hid * 1.125
    # at n = 32768 every shared-expert and proj24 product is bound by its
    # kept products at 989 TFLOP/s, but kv_a and kv_b: 576 and 8192 rows
    # over k 7168 and 512 move B or C at 3.35 TB/s for longer
    assert route.shared_least_s(config, traffic) == pytest.approx(
        shared / 989e12)
    by_bytes = 11 * ((7168 + 576) * t * 2 + 576 * hid * 1.125
                     + (512 + 8192) * t * 2 + 8192 * 512 * 1.125) / 3.35e12
    by_flops = (mla - 11 * t * (576 * hid + 8192 * 512) + dense) / 989e12
    assert route.proj24_least_s(config, traffic) == pytest.approx(
        by_flops + by_bytes)


def test_the_flip_reader_reads_grouped_choices(small_root):
    import torch

    cell = harness.job_cell(tiny_job(CELL, small_root, layers=None,
                                     config=SMALL))
    row = flips_dsv3.seed_flips(cell, SEED, torch.device("cpu"))
    assert len(row["by_layer"]) == len(row["same_input_by_layer"]) == 3
    assert 0 <= row["flip_share_held"] <= row["flip_share"] < 0.15
    assert 0 <= row["same_input_share"] <= row["flip_share"]
    assert row["same_input_violation"] < dsv3mla24.TIE
    assert row["own_choice_readings"][0][0] < 0.1
