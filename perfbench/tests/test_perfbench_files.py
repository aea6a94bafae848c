"""The benchmark's files: ``BENCHMARK.json`` against the contract's
static rules, every cell's files found by name, the configurations
against the published shapes or widths, and a traffic file added as data
alone."""

import ast
import csv
import json
import re
import shutil
from pathlib import Path

import pytest

from perfbench import harness, routes
from perfbench.tests.tiny import MODEL_FILES, RING, TINY, tiny_job, with_ring

ROOT = harness.ROOT
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
# keys that `reduced` may never name: any key with `hidden`,
# `intermediate` or `width` in it, `*_dim` and `*_rank`, as the benchmark
# always refused, and latent, state and projection sizes, head sizes,
# expansion factors and experts per token besides; the one key let through
# is a number of layers such as `num_hidden_layers`, a depth
FORBIDDEN_WIDTHS = re.compile(
    r"^(?!num_\w*layers$).*(hidden|intermediate|width)|(_dim|_rank)$|"
    r"(dim|_units|top_?k)$|latent|state|proj|expan|d_head|d_ssm|"
    r"kv_channels|experts_per_tok")
# a model configuration's keys that are not the source's numbers
MODEL_META = {"name", "source", "published", "reduced", "assumed",
              "deployment", "dtype", "accumulate", "chips"}


@pytest.mark.parametrize("key,width", [
    ("hidden_size", True), ("hidden_sizes", True),
    ("intermediate_size", True), ("intermediate_size_mlp", True),
    ("hidden_size_per_head", True), ("moe_intermediate_size", True),
    ("head_dim", True), ("q_lora_rank", True), ("kv_lora_rank", True),
    ("num_experts_per_tok", True), ("ssm_state_size", True),
    ("embedding_width", True), ("num_hidden_layers", False),
    ("num_layers", False), ("n_routed_experts", False),
    ("vocab_size", False), ("max_position_embeddings", False)])
def test_forbidden_widths_refuse_every_width_and_let_depth_through(
        key, width):
    assert bool(FORBIDDEN_WIDTHS.search(key)) is width, key


def test_benchmark_json_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024
    for path in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", path)
        assert not path.startswith("/") and ".." not in path
    assert len(BENCH["command"]) <= 32
    names = ([c["name"] for c in BENCH["configs"]] + CELLS
             + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
    assert len(names) == len(set(names))
    for name in names:
        assert NAME.match(name), name
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert any(c["file"].startswith(p + "/") for p in BENCH["paths"])
        assert not any(FORBIDDEN_WIDTHS.search(k) for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(
        1, len(CELLS) // 4)
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["moves"] in [e["name"] for e in BENCH["end_to_end"]]
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
        assert "bound" not in m
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_finds_its_files_by_name(cell):
    c = harness.load_cell(cell)
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2 and c.per_layer
    assert issubclass(routes.resolve(c.traffic["route"], c.root),
                      routes.Route)
    assert {"rel_err", "max_err"} <= set(c.checks)
    for m in c.per_layer:
        assert callable(harness.metric_reader(c, m["name"]))


def model_config_faults(data: dict) -> list:
    """What a model configuration gets wrong: ``layers`` given, metadata
    missing, a number run that is not one of ``published``, ``reduced``
    other than exactly the keys run at another value, or a width among
    them."""
    faults = []
    if "layers" in data:
        faults.append("layers")
    if not data.get("published"):
        faults.append("no published")
    faults += sorted({"source", "dtype", "chips", "deployment", "assumed",
                      "reduced"} - set(data))
    published = data.get("published", {})
    faults += [f"{k} not in published" for k in sorted(set(data) - MODEL_META)
               if k not in published]
    changed = {k for k, v in published.items() if data.get(k) != v}
    if set(data.get("reduced", ())) != changed:
        faults.append(f"reduced {data.get('reduced')} is not "
                      f"{sorted(changed)}")
    faults += [f"{k} is a width" for k in sorted(changed)
               if FORBIDDEN_WIDTHS.search(k)]
    return faults


CONFIG_FILES = sorted((ROOT / "perfbench/configs").glob("*.json"))
# the tests' model configuration, so that the check of a model's widths
# runs before a model is in the benchmark
MODEL_CONFIGS = sorted((MODEL_FILES / "configs").glob("*.json"))


@pytest.mark.parametrize("path", CONFIG_FILES + MODEL_CONFIGS,
                         ids=lambda p: p.stem)
def test_config_layers_equal_the_published_csv(path):
    """A GEMM configuration's layers are its published CSV's; a model
    configuration (no ``dataset``) has no layers, runs no number that is
    not one of ``published`` (the source's values), and ``reduced`` names
    exactly the keys run at another value, none of them a width."""
    data = json.loads(path.read_text())
    assert data["name"] == path.stem
    listed = {c["name"]: c for c in BENCH["configs"]}
    if path.stem in listed:
        assert listed[path.stem]["file"] == path.relative_to(
            ROOT).as_posix()
        assert data["reduced"] == listed[path.stem]["reduced"]
    if "dataset" not in data:
        assert model_config_faults(data) == [], path
        return
    with open(ROOT / data["dataset"]) as f:
        rows = [[int(r[k]) for k in ("m", "n", "k", "b")]
                for r in csv.DictReader(f)]
    assert data["layers"] == rows
    assert {r[3] for r in rows} == {data["batch"]}


def _cut(data: dict, **keys) -> dict:
    return dict(data, **keys)


MODEL_CONFIG_FAULTS = {
    "a width cut outside published": lambda d: _cut(
        d, published={k: v for k, v in d["published"].items()
                      if k != "hidden_size"}, hidden_size=128),
    "a number run that the source lacks": lambda d: _cut(d, head_dim=32),
    "a width cut and listed": lambda d: _cut(
        d, intermediate_size=256,
        reduced=d["reduced"] + ["intermediate_size"]),
    "a list of widths cut and listed": lambda d: _cut(
        d, published=dict(d["published"], hidden_sizes=[64, 128]),
        hidden_sizes=[32, 64], reduced=d["reduced"] + ["hidden_sizes"]),
    "a cut left out of reduced": lambda d: _cut(d, reduced=[]),
    "reduced names a key run as published": lambda d: _cut(
        d, reduced=d["reduced"] + ["hidden_size"]),
    "layers given": lambda d: _cut(d, layers=[[1, 1, 1, 1]]),
}


@pytest.mark.parametrize("fault", sorted(MODEL_CONFIG_FAULTS))
def test_a_model_config_that_cuts_a_width_or_hides_a_cut_is_refused(fault):
    data = json.loads(MODEL_CONFIGS[0].read_text())
    assert model_config_faults(data) == []
    assert model_config_faults(MODEL_CONFIG_FAULTS[fault](data)), fault


def test_the_four_card_cell_is_put_back_as_data_alone(tmp_path):
    root = with_ring(tmp_path)
    c = harness.load_cell(RING, root)
    assert c.chips == 4 and c.traffic["route"] == "sparse24_ring"
    assert {m["name"] for m in c.per_layer} >= {"ring24_roofline",
                                                "exchange_ms"}
    for m in c.per_layer:
        assert callable(harness.metric_reader(c, m["name"]))


def test_files_under_paths_are_named_from_name_characters():
    for path in (ROOT / "perfbench").rglob("*"):
        if "__pycache__" in path.parts or path.is_dir():
            continue
        rel = path.relative_to(ROOT).as_posix()
        assert re.fullmatch(r"[A-Za-z0-9_.\-/]+", rel), rel


def test_command_names_no_file_outside_paths():
    for word in BENCH["command"]:
        if "/" in word or word.endswith(".py"):
            assert any(word.startswith(p) for p in BENCH["paths"])


def test_an_added_traffic_file_is_picked_up_with_no_edit(tmp_path):
    """A copy of the benchmark's data with one more cell whose traffic is
    a new data file: the harness finds it and runs it (CPU, tiny)."""
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "perfbench", root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    traffic = json.loads(
        (ROOT / "perfbench/traffic/static24.json").read_text())
    traffic.update(warmup_passes=1, compare="every layer's C")
    (root / "perfbench/traffic/static24_short.json").write_text(
        json.dumps(traffic))
    bench["workloads"].append({"name": "resnet50-b32.static24_short",
                               "config": "resnet50-b32",
                               "traffic": "static24_short", "chips": 1,
                               "why": "added as data alone"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    shutil.copy(root / "perfbench/checks/resnet50-b32.static24.json",
                root / "perfbench/checks/resnet50-b32.static24_short.json")
    cell = harness.load_cell("resnet50-b32.static24_short", root)
    assert cell.traffic["warmup_passes"] == 1
    ranks = harness.run_job(tiny_job(cell.name, root))[0]
    cell.config = dict(cell.config, layers=TINY)
    line = harness.result_line(cell, ranks, False, "cpu", "cpu")
    assert line["correct"] is True
    assert set(line["metrics"]) == {m["name"] for m in BENCH["end_to_end"]}


def _top_level_imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and \
                node.module:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "id", getattr(node.func, "attr", "")) in (
                "__import__", "import_module") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


def test_nothing_imports_jax_or_the_jax_package():
    """Whole top-level names: the port's name begins with the JAX
    package's, and is allowed everywhere but in the reference."""
    files = sorted((ROOT / "perfbench").rglob("*.py"))
    assert files
    for path in files:
        names = set(_top_level_imports(path))
        assert not names & {"jax", "jaxlib", "flax", "sparsifyme_tpu"}, path
    ref = set(_top_level_imports(ROOT / "perfbench/reference.py"))
    assert "sparsifyme_tpu_torch" not in ref
    assert ref <= {"__future__", "typing", "torch"}
    model_refs = [p for p in files if p.parent.name == "model_refs"]
    assert MODEL_FILES / "model_refs" / "mlp24.py" in model_refs
    for path in model_refs:
        names = set(_top_level_imports(path))
        assert names <= {"__future__", "typing", "math", "torch"}, path
    data = set(_top_level_imports(ROOT / "perfbench/data.py"))
    assert "sparsifyme_tpu_torch" not in data
