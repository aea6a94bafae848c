"""The Kimi Linear cell: its configuration's cut (published copied
exactly, only ``num_experts`` reduced, no width), its files found by
name, its route run through the harness on the CPU at a small size (the
configuration's keys and the traffic's lengths cut in a copy of the
benchmark), plain and traced, its planted faults reading not correct,
the shares of eight cards adding up to the uncut MoE layer, and its
readers and work counts."""

import dataclasses
import functools
import json
import shutil
from types import SimpleNamespace

import pytest
import torch

from perfbench import faults_kimi, flips_kimi, harness, reference, routes
from perfbench.model_routes import kimilinear24
from perfbench.tests.kimi_small import (KDA_LAYERS, MLA_LAYERS, MOE_LAYERS,
                                       SMALL)
from perfbench.tests.test_perfbench_files import BENCH, model_config_faults
from perfbench.tests.tiny import SEED, tiny_job
from sparsifyme_tpu_torch.models import moe_transformer as mt

ROOT = harness.ROOT
CELL = "kimi-linear-ep8.kda-prefill32k"
CONFIG = ROOT / "perfbench/configs/kimi-linear-ep8.json"
REF = kimilinear24.REF
NEW = {"kda_ms", "kda_roofline"}
REUSED = {"mimo_mfu", "enqueue_ms", "idle_share", "sparse_speedup", "dispatch_us",
          "launch_us", "expert_roofline", "moe_route_ms", "moe_host_us",
          "proj24_roofline", "shared_expert_roofline", "mla_attention_ms"}


def test_the_cut_is_one_cards_share_and_no_width():
    data = json.loads(CONFIG.read_text())
    assert model_config_faults(data) == []
    assert data["reduced"] == ["num_experts"]
    pub = data["published"]
    assert (pub["num_hidden_layers"], pub["num_experts"]) == (27, 256)
    assert (data["num_hidden_layers"], data["num_experts"]) == (27, 32)
    for key, value in pub.items():
        if key != "num_experts":
            assert data[key] == value, key
    lin = data["linear_attn_config"]
    assert (lin["num_heads"], lin["head_dim"],
            lin["short_conv_kernel_size"]) == (32, 128, 4)
    assert lin["full_attn_layers"] == [4, 8, 12, 16, 20, 24, 27]
    assert len(lin["kda_layers"]) == 20
    assert "EP8" in data["deployment"] and "DP8" in data["deployment"]
    assert any("experts 0-31" in a for a in data["assumed"])
    listed = {c["name"]: c for c in BENCH["configs"]}[data["name"]]
    assert listed["reduced"] == ["num_experts"]
    assert listed["source"] == data["source"]
    assert kimilinear24.moe_layers(data) == list(range(1, 27))
    assert kimilinear24.kda_layers(data) == [
        i for i in range(27) if i not in (3, 7, 11, 15, 19, 23, 26)]
    cfg = kimilinear24.model_config(data)
    assert cfg.n_routed_experts == 256 and cfg.held_experts == tuple(
        range(32))
    assert (cfg.n_group, cfg.routed_scaling_factor, cfg.n_shared_experts,
            cfg.num_experts_per_tok, cfg.norm_topk_prob) == (
        1, 2.446, 1, 8, True)
    assert cfg.q_lora_rank is None and cfg.mla_use_nope
    assert [cfg.attention_kind_of(i) for i in (0, 3, 26)] == [
        "kda", "mla", "mla"]


def test_the_cell_finds_its_files():
    cell = harness.load_cell(CELL)
    assert cell.chips == 1 and cell.layers == []
    route = routes.resolve(cell.traffic["route"], cell.root)
    assert route.__name__ == "KimiLinear24" and route.dense_baseline
    assert {m["name"] for m in cell.per_layer} == NEW | REUSED
    for m in cell.per_layer:
        assert callable(harness.metric_reader(cell, m["name"]))
    t = cell.traffic
    assert t["sequences"] * t["seq_len"] == 32768
    for m in BENCH["per_layer"]:
        if m["name"] in NEW:
            assert m["workloads"] == [CELL]
        elif m["name"] in REUSED:
            assert m["workloads"][-1] == CELL


# the comparison's limits at the CPU's size, set as the cell's are from
# the two kinds of reading at that size: the program reads 0.0114 / 0.054
# and NoPE's fault (RoPE applied in the 2 MLA layers of 128-token
# sequences, the faint one) 0.0197 / 0.097; at the cell's size the limits
# are the checks file's (PERF.md, section 2), where the program reads
# 0.037-0.040 and that fault 0.053
SMALL_CHECKS = {"rel_err": 0.015, "max_err": 0.075}


@pytest.fixture
def small_root(tmp_path):
    """A copy of the benchmark whose traffic runs 2 sequences of 128, with
    the comparison's limits of that size."""
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "perfbench", root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    path = root / "perfbench/traffic/kda-prefill32k.json"
    traffic = json.loads(path.read_text())
    traffic.update(sequences=2, seq_len=128, dense_seconds=0.05)
    path.write_text(json.dumps(traffic))
    (root / "perfbench/checks" / f"{CELL}.json").write_text(
        json.dumps(SMALL_CHECKS))
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
    assert "mla.kv_a mma_sp" in designs and "kda.qkv wgmma_sp" in designs


def test_a_traced_run_reads_the_model_metrics(small_root):
    from sparsifyme_tpu_torch.utils import trace
    trace.reset()
    line, ranks = _line(small_root, True)
    assert line["correct"] is True
    spans = ranks[0]["trace"]["spans"]
    passes = json.loads((small_root / "perfbench/traffic/kda-prefill32k.json")
                        .read_text())["trace_passes"]
    kda_n, mla_n = len(KDA_LAYERS), len(MLA_LAYERS)
    assert spans["perfbench.kda"]["count"] == kda_n * passes
    assert spans["perfbench.kda_core"]["count"] == kda_n * passes
    assert spans["perfbench.attention"]["count"] == mla_n * passes
    assert spans["perfbench.dense_ffn"]["count"] == 1 * passes
    for stage in ("moe_route", "shared_expert", "experts", "moe_combine"):
        assert spans["perfbench." + stage]["count"] == 4 * passes, stage
    # qkv; o in each KDA layer, q, kv_a; kv_b; o in each MLA layer, the
    # dense layer's gate_up; down
    assert spans["perfbench.proj24"]["count"] == (
        2 * kda_n + 3 * mla_n + 2) * passes
    got = line["metrics"]
    # the CPU has no device time: the device readings find nothing
    assert {"mimo_mfu", "moe_host_us", "enqueue_ms", "dispatch_us",
            "sparse_speedup"} <= set(got)
    assert not {"kda_ms", "kda_roofline", "expert_roofline", "idle_share",
                "mla_attention_ms"} & set(got)
    assert 0 < got["mimo_mfu"]["value"] < 100
    summary = trace.summary()
    counters = summary["counters"]
    assert counters["kda.tokens"] % (2 * 2 * 128) == 0
    assert "kda.kernel" not in counters  # the plain form ran
    for phase in ("proj", "conv", "gate", "chunk", "norm", "out"):
        assert summary["spans"]["sparsifyme.kda." + phase]["count"] > 0
    for phase in ("q_latent", "kv_latent", "rope", "core", "out"):
        assert summary["spans"]["sparsifyme.mla." + phase]["count"] > 0
    trace.reset()


def _traced_view(config, traffic, spans, pass_ms=400.0, passes=3):
    trace = {"window_s": 1.0, "busy_s": 0.9,
             "spans": {"perfbench." + name: {"count": 20 * passes,
                                             "all_s": s}
                       for name, s in spans.items()}}
    return SimpleNamespace(config=config, traffic=traffic,
                           route=kimilinear24.KimiLinear24, pass_ms=pass_ms,
                           traces=[trace], trace_passes=passes, world=1)


def test_the_new_readers_read_a_traced_pass(monkeypatch):
    from sparsifyme_tpu_torch.utils import trace

    cell = harness.load_cell(CELL)
    view = _traced_view(cell.config, cell.traffic,
                        {"kda": 0.3, "kda_core": 0.24})
    read = {m: harness.metric_reader(cell, m)
            for m in NEW | {"mimo_mfu"}}
    assert read["kda_ms"](view) == pytest.approx(1e3 * 0.54 / 3)
    flops = kimilinear24.KimiLinear24.pass_flops(cell.config, cell.traffic)
    assert read["mimo_mfu"](view) == pytest.approx(
        100 * flops / (0.4 * 989e12), rel=1e-3)
    # 20 layers x 3 passes of 32768 tokens x 32 heads, counted over 60
    # sparsifyme.kda records
    head_tokens = 60 * 32768 * 32
    monkeypatch.setattr(trace, "summary", lambda: {
        "spans": {"sparsifyme.kda": {"count": 60}},
        "counters": {"kda.tokens": head_tokens}})
    least = kimilinear24.KimiLinear24.kda_least_s(cell.config, head_tokens)
    assert least == pytest.approx(3 * 20 * 32768 * 32 * 1284 / 3.35e12)
    assert read["kda_roofline"](view) == pytest.approx(100 * least / 0.24)
    silent = _traced_view(cell.config, cell.traffic, {"kda": 0.0})
    assert read["kda_ms"](silent) is None
    assert read["kda_roofline"](silent) is None


def test_the_route_counts_the_models_work():
    route = routes.resolve("kimilinear24", ROOT)
    config = json.loads(CONFIG.read_text())
    traffic = harness.load_cell(CELL).traffic
    t, hid = 32768, 2304
    kda_products = 20 * t * (3 * 4096 * hid + hid * 4096)
    kda_low = 20 * 2 * t * (288 * hid + 2 * 4096 * 128)
    kda_core = 20 * t * 32 * (4 * 128 * 128 + 2 * 64 * 256)
    mla = 7 * t * (6144 * hid + 576 * hid + 8192 * 512 + hid * 4096)
    core = 7 * 2 * 8 * 32 * (4096 * 4097 / 2) * (192 + 128)
    dense = t * 3 * 9216 * hid
    moe = 26 * (2 * t * hid * 256 + t * 3 * 1024 * hid
                + route.expert_flops(config, t * 8 * 32 / 256))
    for part, tflop in ((kda_products, 24.7), (kda_low, 2.24),
                        (kda_core, 2.06), (mla, 6.68), (core, 9.62),
                        (dense, 2.09), (moe, 13.1)):
        assert part / 1e12 == pytest.approx(tflop, rel=0.01), tflop
    head = 2 * 8 * hid * 163840
    assert route.pass_flops(config, traffic) == pytest.approx(
        kda_products + kda_low + kda_core + mla + core + dense + moe + head)
    assert route.expert_bytes(config, 0, 1) == 32 * 3 * 1024 * hid * 1.125
    assert route.shared_least_s(config, traffic) == pytest.approx(
        26 * t * 3 * 1024 * hid / 989e12)
    # the recurrence is bound by its bytes: 1284 B against 98 KFLOP a
    # head-token
    assert route.kda_least_s(config, t * 32) == pytest.approx(
        t * 32 * 1284 / 3.35e12)


@pytest.mark.parametrize("fault", faults_kimi.FAULTS)
def test_a_planted_fault_reads_not_correct(small_root, fault):
    """Each planted fault (perfbench/faults_kimi.py)."""
    with faults_kimi.planted(fault):
        line, _ = _line(small_root, False)
    assert line["correct"] is False, (fault, line["checks"])


def test_the_bf16_state_fault_runs_and_is_read(small_root):
    """The reported precision fault runs through the harness and reads
    finite (whether it passes the limits is the card's reading)."""
    with faults_kimi.planted("state_rounded_to_bf16"):
        line, _ = _line(small_root, False)
    assert all(c["value"] < float("inf") for c in line["checks"].values())


def test_the_flip_reader_reads_kimis_choices(small_root):
    cell = harness.job_cell(tiny_job(CELL, small_root, layers=None,
                                     config=SMALL))
    row = flips_kimi.seed_flips(cell, SEED, torch.device("cpu"))
    assert len(row["by_layer"]) == len(row["same_input_by_layer"]) == 4
    assert 0 <= row["flip_share_held"] <= row["flip_share"] < 0.15
    assert row["same_input_violation"] < kimilinear24.TIE
    assert row["own_choice_readings"][0][0] < 0.1


# the shares test: 32 experts over 8 cards of 4 each; the shared expert is
# every card's, counted once
SHARES = 8
WHOLE = dict(SMALL, num_experts=32)
SHARE = dict(SMALL, num_experts=4)


def test_the_shares_of_eight_cards_add_up_to_the_uncut_layer():
    ctx = SimpleNamespace(device=torch.device("cpu"), seed=SEED + 1,
                          config=WHOLE, rank=0,
                          traffic={"sequences": 2, "seq_len": 128})
    full = functools.partial(kimilinear24.weight, ctx)
    kept = functools.partial(kimilinear24.kept_weight, ctx)
    g = torch.Generator().manual_seed(21)
    h = torch.randn((256, 256), generator=g)
    x = REF.rms_norm(h, torch.ones(256), 1e-5)
    whole = kimilinear24.ref_spec(WHOLE)
    layer = MOE_LAYERS[0]
    want = REF.moe(x, whole, layer, kept)
    sel, _ = REF.route(x, whole, layer, kept)
    ref_routed = torch.zeros_like(h)
    port = torch.zeros_like(h.T)
    same = torch.ones(h.shape[0], dtype=torch.bool)
    shared = None
    for j in range(SHARES):
        held = list(range(4 * j, 4 * j + 4))
        spec = dict(kimilinear24.ref_spec(SHARE), held_experts=held)
        ref_routed += REF.routed(x, spec, layer, kept)
        cfg = dataclasses.replace(kimilinear24.model_config(SHARE),
                                  held_experts=tuple(held))
        params = mt.init_params(cfg, full)
        _, moe = params.layers[layer]
        ht = h.T.contiguous()
        xs, d = mt.moe_route(moe, ht, cfg)
        if shared is None:  # every card computes it; counted once
            shared = mt.moe_shared(moe, ht, d) - ht
        d.normed = None
        port += mt.moe_combine(ht, d, mt.moe_experts(moe, xs, d)) - ht
        same &= (d.selected.sort(-1).values == sel.sort(-1).values).all(-1)
    ref = ref_routed + REF.shared_expert(x, whole, layer, kept)
    assert reference.readings(ref, want)[0] < 1e-5
    got = (port + shared).T
    assert same.float().mean() > 0.9
    assert reference.readings(got[same], want[same])[0] < 1e-2
