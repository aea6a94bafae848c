"""A model configuration added as files alone: a copy of the benchmark
gains the 2:4 MLP's route file, its plain reference in ``model_refs/``,
its configuration of widths, a traffic file, limits and a reader
(``tests/model_files/``), and entries in ``BENCHMARK.json``; the harness
runs the cell through the port's ``models/sparse_mlp.forward`` and judges
every batch's output. Faults in the pass read not correct."""

import pytest
import torch

from perfbench import harness, routes
from perfbench.tests.tiny import (MODEL, SEED, TINY_MODEL, tiny_job,
                                  with_model)
from sparsifyme_tpu_torch.models import sparse_mlp


@pytest.fixture
def root(tmp_path):
    return with_model(tmp_path)


def _model_job(root, **kw):
    return tiny_job(MODEL, root, layers=None, config=TINY_MODEL, **kw)


def _line(root, trace=False, **kw):
    job = _model_job(root, trace=trace, **kw)
    ranks = harness.run_job(job)[0]
    cell = harness.job_cell(job)
    return harness.result_line(cell, ranks, trace, "cpu", "cpu"), ranks


def test_an_added_model_is_picked_up_with_no_edit(root):
    cell = harness.load_cell(MODEL, root)
    assert cell.layers == [] and cell.config["num_hidden_layers"] == 2
    route = routes.resolve(cell.traffic["route"], root)
    assert issubclass(route, routes.Route) and route.__name__ == "Mlp24"
    assert harness.job_cell(_model_job(root)).config["hidden_size"] == 64
    line, ranks = _line(root)
    assert line["correct"] is True, line["checks"]
    assert set(line["metrics"]) == {"pass_ms", "pass_p95_ms",
                                    "peak_mem_gib", "setup_s"}
    assert list(line)[-1] == "checks"


def test_a_traced_model_run_reads_its_route_and_config(root):
    line, ranks = _line(root, trace=True)
    assert line["correct"] is True
    spans = ranks[0]["trace"]["spans"]
    cell = harness.load_cell(MODEL, root)
    assert spans["perfbench.mlp24"]["count"] == (
        cell.traffic["trace_passes"] * cell.traffic["batches"])
    assert set(line["metrics"]) == {"enqueue_ms", "mlp24_mfu"}
    assert 0 < line["metrics"]["mlp24_mfu"]["value"] < 100


def test_the_model_control_fails_where_the_program_passes(root):
    cell = harness.load_cell(MODEL, root)
    ranks = harness.run_job(_model_job(root, control_seeds=[SEED]))[0]
    got, ctl = ranks[0]["readings"], ranks[0]["control"]
    for k in ("rel_err", "max_err"):
        assert got[k] <= cell.checks[k] < ctl[k], (k, got[k], ctl[k])


def _one_element_altered(out):
    out = out.clone(memory_format=torch.contiguous_format)
    out.view(-1)[out.numel() // 3] += out.float().square().mean().sqrt()
    return out


def test_a_model_pass_with_an_altered_element_reads_not_correct(
        root, monkeypatch):
    """One element of each layer's product changed where K3's entry
    produces it."""
    real = sparse_mlp.spmm_24
    monkeypatch.setattr(sparse_mlp, "spmm_24", lambda *a, **kw:
                        _one_element_altered(real(*a, **kw)))
    line, _ = _line(root)
    assert line["correct"] is False, line["checks"]


PASS_FAULTS = {
    "one output missing": lambda outs: outs[:-1],
    "one element altered in the last output": (
        lambda outs: outs[:-1] + [_one_element_altered(outs[-1])]),
    "half the batch left out": lambda outs: [
        torch.cat([o[:o.shape[0] // 2], torch.zeros_like(
            o[o.shape[0] // 2:])]) for o in outs],
}


@pytest.mark.parametrize("fault", sorted(PASS_FAULTS))
def test_a_broken_model_pass_reads_not_correct(root, fault, monkeypatch):
    real = routes.resolve

    def broken(name, where):
        route = real(name, where)

        class Broken(route):
            def run_pass(self, state, traced):
                return PASS_FAULTS[fault](super().run_pass(state, traced))

        return Broken

    monkeypatch.setattr(routes, "resolve", broken)
    line, _ = _line(root)
    assert line["correct"] is False, (fault, line["checks"])
    if fault == "one output missing":
        assert line["checks"]["rel_err"]["value"] == float("inf")


@pytest.mark.cuda
def test_the_added_model_runs_on_the_card(root, card):
    """At the configuration file's own widths, traced, with the
    control."""
    job = tiny_job(MODEL, root, layers=None, device="cuda", trace=True,
                   control_seeds=[SEED])
    cell = harness.job_cell(job)
    ranks = harness.run_job(job)[0]
    got, ctl = ranks[0]["readings"], ranks[0]["control"]
    for k in ("rel_err", "max_err"):
        assert got[k] <= cell.checks[k] < ctl[k], (k, got[k], ctl[k])
    line = harness.result_line(cell, ranks, True, "gpu", ranks[0]["kind"])
    assert line["correct"] is True
    assert 0 < line["metrics"]["mlp24_mfu"]["value"] < 100
    assert line["device"]["busy_s"] > 0
