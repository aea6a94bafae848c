"""The benchmark's engine: find a cell's files, set it up, run its window
of passes, trace, check the outputs against the reference, and build the
result line.

Everything particular to a cell lives in files found by name from
``BENCHMARK.json``: the configuration's layers (its ``file``), the traffic
mix (``perfbench/traffic/<traffic>.json``, whose ``route`` picks the path
through the program: one of :mod:`.routes`, or a model's route file
``perfbench/model_routes/<route>.py``), the limits of the comparison
(``perfbench/checks/<workload>.json``) and one reader per per-layer metric
(``perfbench/metrics/<metric>.py``, a ``read(run)`` that returns a number
or ``None``).
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import shutil
import socket
import statistics
import sys
import tempfile
import time
import traceback
from pathlib import Path
from types import SimpleNamespace
from typing import Dict, List, Optional

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "sparsifyme_tpu")
PROFILE_SESSIONS = 3
GIB = float(1 << 30)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    checks: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    root: Path

    @property
    def layers(self):
        """``(rows on a card, n, k)`` per layer, the batch folded into
        rows; none for a configuration that is a whole model (no
        ``layers``), which its route sizes from ``config``."""
        return [(b * m, n, k) for m, n, k, b in self.config.get("layers",
                                                                 [])]


def _applies(metric: dict, cell: str, e2e_names: List[str]) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves") in e2e_names if "moves" in metric else True


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its files."""
    root = Path(root)
    with open(root / "BENCHMARK.json") as f:
        bench = json.load(f)
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                       f"{sorted(work)}")
    w = work[name]
    cfg = {c["name"]: c for c in bench["configs"]}[w["config"]]
    here = root / "perfbench"
    with open(root / cfg["file"]) as f:
        config = json.load(f)
    with open(here / "traffic" / f"{w['traffic']}.json") as f:
        traffic = json.load(f)
    with open(here / "checks" / f"{name}.json") as f:
        checks = json.load(f)
    e2e = [m for m in bench["end_to_end"] if _applies(m, name, [])]
    names = [m["name"] for m in e2e]
    per_layer = [m for m in bench["per_layer"]
                 if _applies(m, name, names)]
    return Cell(name, int(w["chips"]), config, traffic, checks, e2e,
                per_layer, root)


def metric_reader(cell: Cell, metric: str):
    path = cell.root / "perfbench" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + metric.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> List[str]:
    """Top-level names in ``sys.modules`` that the run may not hold."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


# --- one rank's run ------------------------------------------------------

@dataclasses.dataclass
class Ctx:
    device: object
    seed: int
    traffic: dict
    rank: int = 0
    world: int = 1
    mesh: object = None
    # the configuration file's dict, from which a model's route sizes itself
    config: Optional[dict] = None
    # smallest relative gap at the Blocked-ELL cut the reference saw
    ell_margin: Optional[float] = None


def _end_pass(ctx: Ctx, done: bool) -> bool:
    """On several ranks, the one collective that ends a pass; it also
    carries whether any rank's window has closed."""
    if ctx.world == 1:
        return done
    import torch
    import torch.distributed as dist
    flag = torch.tensor([1.0 if done else 0.0], device=ctx.device)
    dist.all_reduce(flag, op=dist.ReduceOp.MAX)
    return bool(flag.item() > 0)


def _traced(route, state, ctx: Ctx, passes: int, sync):
    """``passes`` passes under the profiler with the benchmark's spans;
    returns the trace's summary and the last pass's outputs. A session
    that comes back without device events is made again (every rank
    agrees)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from . import tracing
    cuda = ctx.device.type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                     else [])
    outs, summary = None, None
    for session in range(PROFILE_SESSIONS):
        with profile(activities=acts) as prof:
            with record_function(tracing.WINDOW):
                for _ in range(passes):
                    outs = None
                    with record_function("perfbench.pass"):
                        outs = route.run_pass(state, True)
                        with record_function("perfbench.sync"):
                            sync()
                        with record_function("perfbench.end_collective"):
                            _end_pass(ctx, False)
        tmp = tempfile.mkdtemp(prefix="perfbench_trace_")
        try:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            summary = tracing.summarize_file(path)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        again = cuda and not summary["busy_s"] > 0
        if ctx.world > 1:
            again = _end_pass(ctx, again)
        if not again:
            break
        log(f"profiler session {session + 1} came back without device "
            "events; tracing again")
    return summary, outs


def run_seed(cell: Cell, ctx: Ctx, seconds: float, trace: bool, t0: float,
             control: bool) -> dict:
    """One run of ``cell`` on this rank: set-up, warm-up, the window,
    with ``trace`` the traced passes and the dense baseline, then the
    comparison. Returns this rank's numbers (no tensors)."""
    import torch

    from . import reference, routes
    dev = ctx.device
    cuda = dev.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(dev)) if cuda else (lambda: None)
    traffic, layers = cell.traffic, cell.layers
    route = routes.resolve(traffic["route"], cell.root)()
    state = route.setup(ctx, layers)
    designs = route.designs(state)
    for _ in range(int(traffic["warmup_passes"])):
        route.run_pass(state, False)
        sync()
        _end_pass(ctx, False)
    setup_s = time.time() - t0

    passes, enqueue_s, host_ms, marks = 0, 0.0, [], []
    start = time.perf_counter()
    while True:
        outs = None  # the last pass's outputs go before the next's come
        if cuda:
            e0 = torch.cuda.Event(enable_timing=True)
            e0.record()
        t_pass = time.perf_counter()
        outs = route.run_pass(state, False)
        enqueue_s += time.perf_counter() - t_pass
        if ctx.world > 1:
            sync()
        done = _end_pass(ctx, time.perf_counter() - start >= seconds)
        if cuda:
            e1 = torch.cuda.Event(enable_timing=True)
            e1.record()
            marks.append((e0, e1))
        sync()
        host_ms.append((time.perf_counter() - t_pass) * 1e3)
        passes += 1
        if ctx.world == 1:
            done = time.perf_counter() - start >= seconds
        if done:
            break
    window_s = time.perf_counter() - start
    pass_ms = ([a.elapsed_time(b) for a, b in marks] if cuda else host_ms)
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0

    res = {"rank": ctx.rank, "kind": (torch.cuda.get_device_name(dev)
                                      if cuda else "cpu"),
           "passes": passes, "window_s": window_s,
           "pass_times_ms": pass_ms, "enqueue_ms": enqueue_s * 1e3 / passes,
           "peak_bytes": peak, "setup_s": setup_s, "designs": designs}
    if trace:
        res["trace"], outs = _traced(route, state, ctx,
                                     int(traffic["trace_passes"]), sync)
        if route.dense_baseline:
            res["dense_pass_ms"] = _dense_baseline(
                route, ctx, layers, state, traffic, sync)

    del state
    # the outputs go one by one as they are judged, so the reference fits
    count = route.outputs(ctx, layers)
    outs = list(outs) if len(outs) == count else [None] * count
    worst = {"rel_err": 0.0, "max_err": 0.0}
    ctrl = dict(worst)
    for i in range(count):
        ref, ctl = route.reference(ctx, layers, i, control)
        got, outs[i] = outs[i], None
        for key, v in zip(worst, (float("inf"),) * 2 if got is None
                          else reference.readings(got, ref)):
            worst[key] = max(worst[key], v)
        if ctl is not None:
            for key, v in zip(ctrl, reference.readings(ctl, ref)):
                ctrl[key] = max(ctrl[key], v)
        del ref, ctl, got
    res["readings"] = worst
    if control:
        res["control"] = ctrl
    if ctx.ell_margin is not None:
        res["ell_margin"] = ctx.ell_margin
    res["forbidden"] = forbidden_modules()
    return res


def _dense_baseline(route, ctx, layers, state, traffic, sync) -> float:
    """The dense pass (``batched_gemm`` on the same dense A, cuBLAS) timed
    over at least ``dense_seconds`` after one warm pass: ms a pass."""
    pairs = route.dense_inputs(ctx, layers, state)
    outs = route.dense_pass(pairs)
    sync()
    outs, n = None, 0
    t = time.perf_counter()
    while n < 3 or time.perf_counter() - t < traffic["dense_seconds"]:
        outs = None
        outs = route.dense_pass(pairs)
        sync()
        n += 1
    ms = (time.perf_counter() - t) * 1e3 / n
    del outs, pairs
    return ms


def run_seeds(cell: Cell, job: dict, rank: int = 0, world: int = 1,
              mesh=None) -> List[dict]:
    """Every seed of ``job`` on this rank; on several ranks, rank 0 gets
    every rank's numbers per seed (others get ``[]``)."""
    import torch
    dev = torch.device(job["device"])
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    out = []
    for seed in job["seeds"]:
        ctx = Ctx(dev, int(seed), cell.traffic, rank, world, mesh,
                  config=cell.config)
        res = run_seed(cell, ctx, job["seconds"], job["trace"], job["t0"],
                       int(seed) in job.get("control_seeds", ()))
        if world > 1:
            import torch.distributed as dist
            every = [None] * world
            dist.all_gather_object(every, res)
            res = every
        else:
            res = [res]
        out.append(res if rank == 0 else None)
    return out if rank == 0 else []


# --- several ranks --------------------------------------------------------

def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def rank_main(rank: int, world: int, port: int, job: dict, queue) -> None:
    """A rank's process: join the process group over ``localhost``, run
    the job's seeds on a process mesh, and report to the launcher."""
    try:
        from sparsifyme_tpu_torch.parallel.mesh import (init_distributed,
                                                        make_mesh)
        cell = job_cell(job)
        init_distributed(f"tcp://localhost:{port}", world, rank,
                         timeout_s=job.get("collective_timeout_s", 300))
        mesh = make_mesh((world,), ("model",))
        out = run_seeds(cell, job, rank, world, mesh)
        queue.put((rank, "ok", out, forbidden_modules()))
    except BaseException:
        queue.put((rank, "error", traceback.format_exc(), []))
        raise
    finally:
        import torch.distributed as dist
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(job: dict, world: int, timeout_s: float,
              target=rank_main) -> List[List[dict]]:
    """Start ``world`` rank processes (one card each) running ``target``,
    wait for all, stop them, and return rank 0's numbers per seed. Raises
    if a rank fails or the time runs out."""
    import multiprocessing as mp
    import queue as queue_mod
    mpc = mp.get_context("spawn")
    q = mpc.Queue()
    port = _free_port()
    procs = [mpc.Process(target=target, args=(r, world, port, job, q))
             for r in range(world)]
    for p in procs:
        p.start()
    results, errors, forbidden = {}, [], set()
    deadline = time.time() + timeout_s
    try:
        while len(results) + len(errors) < world:
            left = deadline - time.time()
            if left <= 0:
                raise TimeoutError(f"ranks did not finish in {timeout_s} s")
            try:
                rank, status, payload, bad = q.get(timeout=min(left, 5.0))
            except queue_mod.Empty:
                if any(p.exitcode not in (None, 0) for p in procs) and \
                        q.empty():
                    dead = [r for r, p in enumerate(procs)
                            if p.exitcode not in (None, 0)]
                    raise RuntimeError(f"rank(s) {dead} exited without a "
                                       "report")
                continue
            forbidden.update(bad)
            if status == "ok":
                results[rank] = payload
            else:
                errors.append(f"rank {rank}:\n{payload}")
                break
        if errors:
            raise RuntimeError("a rank failed:\n" + "\n".join(errors))
    finally:
        for p in procs:
            p.join(timeout=30 if not errors else 5)
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()
        q.close()
        q.join_thread()
    if forbidden:
        raise RuntimeError(f"a rank loaded {sorted(forbidden)}")
    return results[0]


def job_cell(job: dict) -> Cell:
    """The job's cell, with ``job["config"]`` (keys of the configuration
    file) merged over its configuration and ``job["layers"]`` over its
    layers, where the job gives them: the sizes of the tests' runs."""
    cell = load_cell(job["workload"], Path(job["root"]))
    if job.get("config") is not None:
        cell.config = dict(cell.config, **job["config"])
    if job.get("layers") is not None:
        cell.config = dict(cell.config, layers=job["layers"])
    return cell


def run_job(job: dict) -> List[List[dict]]:
    """The job's seeds on its cell: in this process on one chip, or in one
    process a rank on several. Per seed, every rank's numbers."""
    cell = job_cell(job)
    if cell.chips == 1:
        return run_seeds(cell, job)
    if job["device"] == "cuda":
        # build the program's kernels once here, not in every rank at once
        from sparsifyme_tpu_torch import _build
        _build.build_all()
    return run_ranks(job, cell.chips, job.get("timeout_s", 1150))


# --- the result line -----------------------------------------------------

def p95(values: List[float]) -> float:
    if len(values) < 2:
        return values[0]
    return statistics.quantiles(values, n=100, method="inclusive")[94]


def end_to_end_values(ranks: List[dict]) -> Dict[str, float]:
    r0 = ranks[0]
    return {"pass_ms": r0["window_s"] * 1e3 / r0["passes"],
            "pass_p95_ms": p95(r0["pass_times_ms"]),
            "peak_mem_gib": max(r["peak_bytes"] for r in ranks) / GIB,
            "setup_s": r0["setup_s"]}


def reader_view(cell: Cell, ranks: List[dict]) -> SimpleNamespace:
    """What a per-layer metric's reader gets: ``config`` and ``route``
    (the route's class) let a model's readers count its work with the
    functions of its route file."""
    from . import routes
    e2e = end_to_end_values(ranks)
    return SimpleNamespace(
        cell=cell.name, layers=cell.layers, traffic=cell.traffic,
        config=cell.config,
        route=routes.resolve(cell.traffic["route"], cell.root),
        world=len(ranks), pass_ms=e2e["pass_ms"],
        enqueue_ms=[r["enqueue_ms"] for r in ranks],
        dense_pass_ms=ranks[0].get("dense_pass_ms"),
        traces=[r.get("trace") for r in ranks],
        trace_passes=int(cell.traffic["trace_passes"]))


def result_line(cell: Cell, ranks: List[dict], trace: bool,
                platform: str, kind: str) -> dict:
    """The contract's last line of standard output, and the checks."""
    readings = {k: max(r["readings"][k] for r in ranks)
                for k in ("rel_err", "max_err")}
    checks = {k: {"value": readings[k], "limit": float(cell.checks[k])}
              for k in ("rel_err", "max_err")}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    metrics = {}
    if trace:
        view = reader_view(cell, ranks)
        for m in cell.per_layer:
            v = metric_reader(cell, m["name"])(view)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        values = end_to_end_values(ranks)
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    device = {"platform": platform, "kind": kind, "count": len(ranks),
              "memory_peak_bytes": max(r["peak_bytes"] for r in ranks)}
    line = {"correct": correct, "attempted": ranks[0]["passes"],
            "failed": 0, "metrics": metrics, "device": device}
    if trace:
        traces = [r["trace"] for r in ranks]
        device["busy_s"] = sum(t["busy_s"] for t in traces) / len(traces)
        device["window_s"] = traces[0]["window_s"]
        line["breakdown"] = {"device_ops": traces[0]["device_ops"],
                             "idle_gaps": traces[0]["idle_gaps"]}
    line["checks"] = checks
    return line
