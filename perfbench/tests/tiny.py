"""The tiny sizes at which the benchmark's tests run a cell on the CPU,
through the port's plain versions."""

import json
import shutil
import time
from pathlib import Path

from perfbench import harness

# rows (b * m) are whole 128-row blocks and n whole 64-column tiles, as
# pack_wg and the ELL blocks need; k = 147 is ragged like the stem's
TINY = [[16, 64, 147, 8], [16, 128, 64, 8], [4, 64, 576, 32]]
SEED = 2 ** 31 + 11


def tiny_cell(workload: str, root=harness.ROOT) -> harness.Cell:
    cell = harness.load_cell(workload, root)
    cell.config = dict(cell.config, layers=TINY)
    return cell


def tiny_job(workload: str, root=harness.ROOT, **kw) -> dict:
    job = {"workload": workload, "root": str(root), "seeds": [SEED],
           "seconds": 0.05, "trace": False, "t0": time.time(),
           "device": "cpu", "layers": TINY, "timeout_s": 240}
    job.update(kw)
    return job


# The four-card cell (BASELINE config 5) is out of BENCHMARK.json until
# its pass time holds a bound (PERF.md, Open questions); its files stay,
# and these are the entries that put it back.
RING = "resnet50-b32x4.ring24"
RING_ENTRIES = {
    "configs": [{"name": "resnet50-b32x4",
                 "source": "https://arxiv.org/abs/1512.03385",
                 "file": "perfbench/configs/resnet50-b32x4.json",
                 "reduced": [],
                 "why": "ResNet-50 row-split over 4 cards (BASELINE config "
                        "5): global batch 128, 32 images a card"}],
    "workloads": [{"name": RING, "config": "resnet50-b32x4",
                   "traffic": "ring24", "chips": 4,
                   "why": "49 layers a pass through spmm_24_ring_explicit "
                          "(K7) on a 4-process NCCL ring, one client in a "
                          "closed loop"}],
    "per_layer": [
        {"name": "ring24_roofline", "unit": "%", "better": "higher",
         "source": "device_trace", "layer": "kernels", "moves": "pass_ms",
         "workloads": [RING]},
        {"name": "exchange_ms", "unit": "ms", "better": "lower",
         "source": "device_trace", "layer": "parallel", "moves": "pass_ms",
         "workloads": [RING]}],
}


def _copy_with(tmp_path, entries: dict, cell: str, read_by,
               files: Path | None = None) -> Path:
    """A copy of the benchmark with ``files`` (a tree laid out as
    ``perfbench/``) added beside its own, ``entries`` added to its
    ``BENCHMARK.json``, and ``cell`` added to the ``workloads`` of the
    metrics named in ``read_by``; returns its root."""
    root = tmp_path / "checkout"
    shutil.copytree(harness.ROOT / "perfbench", root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for path in (files.rglob("*") if files else ()):
        if path.is_file() and "__pycache__" not in path.parts:
            dest = root / "perfbench" / path.relative_to(files)
            assert not dest.exists(), dest  # added, never over a file
            dest.parent.mkdir(parents=True, exist_ok=True)
            shutil.copy(path, dest)
    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    for key, more in entries.items():
        bench[key] += more
    for m in bench["per_layer"] + bench["end_to_end"]:
        if "workloads" in m and m["name"] in read_by and \
                cell not in m["workloads"]:
            m["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def with_ring(tmp_path) -> Path:
    """A copy of the benchmark with the four-card cell put back, as data
    alone; returns its root."""
    return _copy_with(tmp_path, RING_ENTRIES, RING, (
        "pass_ms", "peak_mem_gib", "setup_s", "enqueue_ms", "idle_share",
        "pass_mfu"))


# A model cell added as files alone: the files under model_files/ go into
# a copy of the benchmark beside its own, and these entries into its
# BENCHMARK.json.
MODEL = "sparse-mlp.mlp24"
MODEL_FILES = Path(__file__).resolve().parent / "model_files"
MODEL_ENTRIES = {
    "configs": [{"name": "sparse-mlp",
                 "source": "sparsifyme_tpu_torch/models/sparse_mlp.py",
                 "file": "perfbench/configs/sparse-mlp.json",
                 "reduced": ["num_hidden_layers"],
                 "why": "the port's 2:4 MLP, a whole model by its widths"}],
    "workloads": [{"name": MODEL, "config": "sparse-mlp",
                   "traffic": "mlp24", "chips": 1,
                   "why": "4 batches of 512 tokens a pass through "
                          "sparse_mlp.forward, K3 a layer, one client in "
                          "a closed loop"}],
    "per_layer": [
        {"name": "mlp24_mfu", "unit": "%", "better": "higher",
         "source": "host_clock", "layer": "whole pass", "moves": "pass_ms",
         "workloads": [MODEL]}],
}
# the CPU tests' sizes, merged over the configuration's keys
TINY_MODEL = {"hidden_size": 64, "intermediate_size": 128}


def with_model(tmp_path) -> Path:
    """A copy of the benchmark with the model cell added as files and
    entries alone, and ``enqueue_ms`` read there too; returns its root."""
    return _copy_with(tmp_path, MODEL_ENTRIES, MODEL, ("enqueue_ms",),
                      MODEL_FILES)
