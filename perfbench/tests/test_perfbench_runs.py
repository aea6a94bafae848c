"""Cells run through the port's CPU path at tiny sizes, called from the
tests (the command itself refuses to run without a card): each traffic's
pass, the comparison and its control, the faults it must catch, the
roofline arithmetic, and the command's refusal without a card."""

import json

import pytest
import torch

from perfbench import harness, reference, roofline, run
from perfbench.tests.tiny import (RING, SEED, TINY, tiny_cell, tiny_job,
                                  with_ring)
from sparsifyme_tpu_torch.containers import Sparse24
from sparsifyme_tpu_torch.ops import ell as ell_ops
from sparsifyme_tpu_torch.ops import sparse24
from sparsifyme_tpu_torch.parallel import ring_kernel

ONE_CHIP = ["resnet50-b32.static24", "resnet152-b32.pipeline24",
            "resnet50-b32.ell50"]


def _line(workload, trace=False, root=harness.ROOT, **kw):
    cell = tiny_cell(workload, root)
    ranks = harness.run_job(tiny_job(workload, root, trace=trace, **kw))[0]
    return harness.result_line(cell, ranks, trace, "cpu", "cpu"), ranks


@pytest.mark.parametrize("workload", ONE_CHIP + [RING])
def test_each_traffic_runs_a_tiny_pass_correctly(workload, tmp_path):
    root = with_ring(tmp_path) if workload == RING else harness.ROOT
    line, ranks = _line(workload, root=root)
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert set(line["metrics"]) == {"pass_ms", "pass_p95_ms",
                                    "peak_mem_gib", "setup_s"}
    assert list(line)[-1] == "checks"
    assert line["device"]["count"] == (4 if workload == RING else 1)
    json.dumps(line)


@pytest.mark.parametrize("workload", ONE_CHIP)
def test_a_traced_run_reads_the_same_and_reports_its_window(workload):
    line, ranks = _line(workload, trace=True)
    assert line["correct"] is True
    assert line["device"]["window_s"] > 0
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    spans = ranks[0]["trace"]["spans"]
    calls = len(TINY) * tiny_cell(workload).traffic["trace_passes"]
    stage = {"sparse24_static": "spmm24", "sparse24_pipeline": "pack_wg",
             "ell": "ell"}[tiny_cell(workload).traffic["route"]]
    assert spans["perfbench." + stage]["count"] == calls
    # the host's own readings; device readings have no device to read
    assert "enqueue_ms" in line["metrics"] and "pass_mfu" in line["metrics"]
    assert "spmm24_roofline" not in line["metrics"]


@pytest.mark.parametrize("workload", ONE_CHIP)
def test_the_control_fails_where_the_program_passes(workload):
    """The reference one precision down (fp8 inputs) in the program's
    place reads above the limits that the program's runs stay under."""
    cell = tiny_cell(workload)
    ranks = harness.run_job(tiny_job(workload, control_seeds=[SEED]))[0]
    got, ctl = ranks[0]["readings"], ranks[0]["control"]
    for k in ("rel_err", "max_err"):
        assert got[k] <= cell.checks[k] < ctl[k], (k, got[k], ctl[k])


def _zeros(out):
    return torch.zeros_like(out)


def _half(out):
    out = out.clone()
    out[out.shape[0] // 2:] = 0
    return out


def _altered(out):
    out = out.clone()
    out.view(-1)[out.numel() // 3] += out.float().square().mean().sqrt()
    return out


FAULTS = {"unwritten output": _zeros, "half the batch left out": _half,
          "one answer altered": _altered}
ENTRY = {"resnet50-b32.static24": (sparse24, "spmm_24"),
         "resnet152-b32.pipeline24": (sparse24, "spmm_24"),
         "resnet50-b32.ell50": (ell_ops, "spmm_ell")}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("workload", ONE_CHIP)
def test_a_broken_timed_path_reads_not_correct(workload, fault,
                                               monkeypatch):
    mod, name = ENTRY[workload]
    real = getattr(mod, name)
    monkeypatch.setattr(mod, name,
                        lambda *a, **kw: FAULTS[fault](real(*a, **kw)))
    line, _ = _line(workload)
    assert line["correct"] is False, (fault, line["checks"])


def _local_only(s, b, mesh, axis="model", *, out_dtype=None, design=None):
    """The ring with its exchange left out: this rank's own k-slice times
    its own B shard."""
    p, me = mesh.shape[axis], mesh.axis_index(axis)
    k4s = s.values0.shape[-2] // p
    g = slice(me * k4s, (me + 1) * k4s)
    part = Sparse24(s.values0[g], s.values1[g], s.codes[g],
                    shape=(s.values0.shape[-1], 4 * k4s))
    return sparse24.spmm_24(part, b, out_dtype=out_dtype)


def _broken_rank(rank, world, port, job, queue):
    real = ring_kernel.spmm_24_ring_explicit
    fault = job["fault"]
    if fault == "exchange left out":
        ring_kernel.spmm_24_ring_explicit = _local_only
    else:
        ring_kernel.spmm_24_ring_explicit = (
            lambda *a, **kw: FAULTS[fault](real(*a, **kw)))
    harness.rank_main(rank, world, port, job, queue)


@pytest.mark.parametrize("fault", sorted(FAULTS) + ["exchange left out"])
def test_a_broken_ring_reads_not_correct(fault, tmp_path):
    root = with_ring(tmp_path)
    cell = tiny_cell(RING, root)
    job = tiny_job(RING, root, fault=fault)
    ranks = harness.run_ranks(job, 4, 240, target=_broken_rank)[0]
    line = harness.result_line(cell, ranks, False, "cpu", "cpu")
    assert line["correct"] is False, (fault, line["checks"])


def test_the_reference_keeps_ties_to_the_later_position():
    a = torch.tensor([[1.0, -1.0, 1.0, 0.5, 2.0, 2.0, -2.0, 2.0, 3.0]])
    kept = reference.keep_24(a)
    assert kept.tolist() == [[0.0, -1.0, 1.0, 0.0, 0.0, 0.0, -2.0, 2.0,
                              3.0]]


def test_the_reference_keeps_the_largest_blocks():
    a = torch.ones(4, 8)
    a[:2, 2:4] = 3.0  # block-row 0 keeps block 1
    a[2:, 6:] = -5.0  # block-row 1 keeps block 3
    kept, margin = reference.ell_keep(a, 2, 2, 1)
    assert kept.abs().sum().item() == 2 * 2 * 3.0 + 2 * 2 * 5.0
    assert margin == pytest.approx(1.0 - 4.0 / 36.0)


def test_roofline_arithmetic_by_hand():
    # U: 784x256x1024 at b=32, rows 25088
    assert roofline.kept_flops_24(25088, 256, 1024) == 6_576_668_672
    assert roofline.spmm24_bytes(25088, 256, 1024) == (
        28_901_376 + 524_288 + 12_845_056)
    assert roofline.bound_s(6_576_668_672, 42_270_720) == pytest.approx(
        42_270_720 / 3.35e12)  # bound by bytes, 12.618 us
    assert roofline.pipeline24_bytes(25088, 256, 1024) == (
        51_380_224 + 524_288 + 12_845_056)
    # D: 196x512x4608 at b=32, rows 6272
    assert roofline.kept_flops_24(6272, 512, 4608) == 14_797_504_512
    assert roofline.spmm24_bytes(6272, 512, 4608) == (
        32_514_048 + 4_718_592 + 6_422_528)
    assert roofline.bound_s(14_797_504_512, 43_655_168) == pytest.approx(
        14_797_504_512 / 989e12)  # bound by operations, 14.962 us
    # the ring at D on one rank: B whole (k 4608 is whole 64s), A, C
    assert roofline.ring24_bytes(6272, 512, 4608) == 43_655_168
    # ELL at U: block_k 64, k 1024 -> 16 blocks, 8 kept, 512 columns
    ell = {"block_size": 128, "block_k_rule": [[512, 32], [1536, 64],
                                               [None, 128]],
           "keep_share": 0.5}
    assert roofline.ell_geometry(ell, 1024) == (128, 64, 1024, 8)
    assert roofline.ell_geometry(ell, 147) == (128, 32, 192, 3)
    assert roofline.ell_flops(25088, 256, 512) == 6_576_668_672
    assert roofline.ell_bytes(25088, 256, 1024, 512, 128, 64) == (
        25_690_112 + 196 * 8 * 4 + 524_288 + 12_845_056)


def test_the_command_refuses_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "resnet50-b32.static24", "--seed", "0",
                   "--seconds", "10", "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""
    assert "needs 1 CUDA card" in out.err


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ONE_CHIP)
def test_each_route_runs_a_tiny_pass_on_the_card(workload, card):
    ranks = harness.run_job(tiny_job(workload, device="cuda",
                                     control_seeds=[SEED]))[0]
    cell = tiny_cell(workload)
    got, ctl = ranks[0]["readings"], ranks[0]["control"]
    for k in ("rel_err", "max_err"):
        assert got[k] <= cell.checks[k] < ctl[k]
