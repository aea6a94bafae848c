"""The port's process mesh (one rank per process) against the JAX package
and against the port's one-process mesh, on the same numpy inputs.

One module fixture runs a gloo job at P = 2 and one at P = 4 processes
(``tests/torch_mp_worker.py``, spawned, ``file://`` init under a temporary
directory, every collective bounded by a 45 s timeout and every process
joined under a deadline). Each rank runs every op on its blocks and writes
them to an ``.npz``; the tests put the blocks together and compare. JAX
runs on the 8-device virtual CPU mesh that ``tests/conftest.py`` forces,
its Pallas rings in interpret mode. Tolerances: products 1e-4 relative in
f32 (sums in another order), the train step 1e-5 and the codes exactly
(as ``tests/test_torch_models.py``), the collectives 1e-6 (f32) and 2e-2
(bf16); against the one-process mesh, which runs the same local ops on the
same blocks, 1e-6.
"""

import json
import multiprocessing
import pathlib
import socket
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh
from jax.sharding import PartitionSpec as PS

import torch_mp_worker as worker
from sparsifyme_tpu.models import sparse_mlp as jmlp
from sparsifyme_tpu.ops import prune as jprune
from sparsifyme_tpu.ops import sparse24 as js
from sparsifyme_tpu.parallel import ring_kernel as jrk
from sparsifyme_tpu.parallel import spmm_sharded as jsh
from sparsifyme_tpu_torch.convert import (mlp_params_from_numpy,
                                          sparse24_from_numpy,
                                          tensor_from_numpy, tensor_to_numpy)
from sparsifyme_tpu_torch.entry import train_mesh_shape
from sparsifyme_tpu_torch.models import sparse_mlp as tmlp
from sparsifyme_tpu_torch.parallel import mesh as tmesh
from sparsifyme_tpu_torch.parallel import ring_kernel as trk
from sparsifyme_tpu_torch.parallel import spmm_sharded as tsh

PS_ = (2, 4)
DEADLINE_S = 150  # both jobs, spawn to exit
TOL = 1e-4
STEP_TOL = 1e-5
COLL_TOL = 1e-6
SAME_TOL = 1e-6
DIMS = (32, 64, 32)
# name: (batch, m, k, n) of each SpMM problem; batch 0 is unbatched
PROBLEMS = {"bs": (8, 16, 64, 24), "rs": (2, 64, 32, 16),
            "ring": (8, 16, 128, 24), "k7": (2, 32, 128, 24)}


def _k7t(p):
    return (0, 256 * p, 64 * p, 24)  # two m-tiles of 128 per rank


def _problem(rng, batch, m, k, n):
    """JAX (Sparse24, B) of one pruned f32 A and B, and their numpy."""
    a = rng.normal(size=(batch, m, k) if batch else (m, k)).astype(np.float32)
    b = rng.normal(size=(k, n)).astype(np.float32)
    s = js.compress_24(jprune.prune_24(jnp.asarray(a))[0])
    return s, jnp.asarray(b)


def _put(inputs, name, s, b):
    inputs[f"{name}_v0"] = np.asarray(s.values0)
    inputs[f"{name}_v1"] = np.asarray(s.values1)
    inputs[f"{name}_codes"] = np.asarray(s.codes)
    inputs[f"{name}_shape"] = np.array(s.shape)
    inputs[f"{name}_b"] = np.asarray(b)


def _inputs(p):
    """Every input of the P-process job, and the JAX operands."""
    rng = np.random.default_rng(100 + p)
    dp, tp = train_mesh_shape(p)
    inputs, ops = {}, {}
    for name, dims in {**PROBLEMS, "k7t": _k7t(p)}.items():
        ops[name] = _problem(rng, *dims)
        _put(inputs, name, *ops[name])
    inputs["ag_x"] = rng.normal(size=(p, 2, 3)).astype(np.float32)
    inputs["ag_ct"] = rng.normal(size=(p, 2 * tp, 3)).astype(np.float32)
    inputs["pm_x"] = rng.normal(size=(p, 5)).astype(np.float32)
    config = jmlp.MlpConfig(dims=DIMS, dtype="float32")
    start = jmlp.init_params(jax.random.PRNGKey(0), config)
    for i, layer in enumerate(start):
        for j, t in enumerate(layer):
            inputs[f"mlp_{i}_{j}"] = np.asarray(t)
    inputs["mlp_layers"] = np.array(len(start))
    inputs["mlp_dims"] = np.array(DIMS)
    inputs["mlp_x"] = rng.normal(size=(16, DIMS[0])).astype(np.float32)
    inputs["mlp_y"] = rng.normal(size=(16, DIMS[-1])).astype(np.float32)
    return inputs, ops, start


def _spawn(target, world, workdir, *args):
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=target, args=(r, world, str(workdir), *args))
             for r in range(world)]
    for proc in procs:
        proc.start()
    return procs


def _join(procs, workdir, deadline):
    """Each rank's ``.npz``; fails (and kills what is left) on a rank's
    error, a non-zero exit or the deadline."""
    for proc in procs:
        proc.join(max(0.0, deadline - time.monotonic()))
    alive = [proc for proc in procs if proc.is_alive()]
    for proc in alive:
        proc.kill()
        proc.join(10)
    errors = [f.read_text() for f in sorted(workdir.glob("error*.txt"))]
    codes = [proc.exitcode for proc in procs]
    if alive or errors or any(codes):
        raise AssertionError(f"{len(alive)} ranks past the deadline, exit "
                             f"codes {codes}:\n" + "\n".join(errors))
    return [dict(np.load(workdir / f"rank{r}.npz"))
            for r in range(len(procs))]


def _jax_collectives(inputs, p):
    """JAX's all_gather (with its vjp) and pmean on the (dp, tp) mesh."""
    dp, tp = train_mesh_shape(p)
    mesh = JMesh(np.array(jax.devices()[:p]).reshape(dp, tp),
                 ("data", "model"))
    spec = PS(("data", "model"))

    def smap(f):
        return jax.shard_map(f, mesh=mesh, in_specs=spec, out_specs=spec,
                             check_vma=False)

    x = jnp.asarray(inputs["ag_x"].reshape(p * 2, 3))
    gather = smap(lambda v: jax.lax.all_gather(v, "model", axis=0,
                                               tiled=True))
    full, vjp = jax.vjp(gather, x)
    (grad,) = vjp(jnp.asarray(inputs["ag_ct"].reshape(p * 2 * tp, 3)))
    data = smap(lambda v: jax.lax.all_gather(v, "data", axis=1,
                                             tiled=True))(x)
    pm = jnp.asarray(inputs["pm_x"])
    mean = smap(lambda v: jax.lax.pmean(v, "data"))(pm)
    mean_bf16 = smap(lambda v: jax.lax.pmean(v, "model"))(
        pm.astype(jnp.bfloat16))
    return {"ag_full": full.reshape(p, 2 * tp, 3),
            "ag_grad": grad.reshape(p, 2, 3),
            "ag_data": data.reshape(p, 2, 3 * dp),
            "pmean": mean, "pmean_bf16": mean_bf16}


def _jax_steps(start, inputs, p):
    dp, tp = train_mesh_shape(p)
    mesh = JMesh(np.array(jax.devices()[:p]).reshape(dp, tp),
                 ("data", "model"))
    step = jmlp.make_train_step(mesh, jmlp.MlpConfig(dims=DIMS,
                                                     dtype="float32"),
                                lr=worker.LR)
    params, runs = start, {}
    for n in range(1, worker.STEPS + 1):
        loss, params = step(params, jnp.asarray(inputs["mlp_x"]),
                            jnp.asarray(inputs["mlp_y"]))
        runs[n] = (float(loss), [tuple(np.asarray(t) for t in layer)
                                 for layer in params])
    return runs


def _jax_products(ops, p):
    jm = JMesh(np.array(jax.devices()[:p]), ("model",))
    jd = JMesh(np.array(jax.devices()[:p]), ("data",))
    f32 = jnp.float32
    return {
        "bs": jsh.spmm_24_batch_sharded(*ops["bs"], jd, "data"),
        "rs": jsh.spmm_24_row_sharded(*ops["rs"], jm, "model"),
        "ring": jsh.spmm_24_ring(*ops["ring"], jm, "model", out_dtype=f32),
        "k7": jrk.spmm_24_ring_pallas(*ops["k7"], jm, "model",
                                      out_dtype=f32),
        "k7t": jrk.spmm_24_ring_tiled_pallas(*ops["k7t"], jm, "model",
                                             out_dtype=f32, m_tile=128),
    }


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Per P: the ranks' outputs, the inputs, the JAX results."""
    jobs = {}
    for p in PS_:
        work = tmp_path_factory.mktemp(f"p{p}")
        inputs, ops, start = _inputs(p)
        np.savez(work / "inputs.npz", **inputs)
        jobs[p] = (work, inputs, ops, start,
                   _spawn(worker.job, p, work))
    deadline = time.monotonic() + DEADLINE_S
    out = {}
    try:
        for p, (work, inputs, ops, start, _) in jobs.items():
            out[p] = {"inputs": inputs, "ops": ops, "start": start,
                      "jax": {**_jax_products(ops, p),
                              **_jax_collectives(inputs, p)},
                      "steps": _jax_steps(start, inputs, p)}
    finally:
        for p, (work, *_, procs) in jobs.items():
            out.setdefault(p, {})["ranks"] = _join(procs, work, deadline)
    return out


def _np(a):
    return np.asarray(a, np.float32)


def _rel(got, want):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _blocks(ranks, key, rank_ids=None):
    ids = range(len(ranks)) if rank_ids is None else rank_ids
    return np.concatenate([ranks[r][key] for r in ids], axis=0)


def _model_ranks(p, d):
    dp, tp = train_mesh_shape(p)
    return [d * tp + m for m in range(tp)]


def _assembled_params(ranks, p, tag):
    """Whole parameters from the ranks of each data index: the planes'
    columns and the bias split over ``model``."""
    dp, _ = train_mesh_shape(p)
    per_d = []
    for d in range(dp):
        ids = _model_ranks(p, d)
        per_d.append([tuple(
            np.concatenate([ranks[r][f"{tag}_{i}_{j}"] for r in ids],
                           axis=0 if j == 3 else 1) for j in range(4))
            for i in range(len(DIMS) - 1)])
    return per_d


@pytest.mark.parametrize("p", PS_)
def test_ranks_run_on_cpu_devices_over_gloo(runs, p):
    for rank in runs[p]["ranks"]:
        assert list(rank["devices"]) == ["cpu"] * p


@pytest.mark.parametrize("p", PS_)
def test_meshes_share_one_group_per_rank_set(runs, p):
    """A rank set gets one process group per process: a second mesh
    over it reuses the first's, and the whole world's is the default
    group."""
    for rank in runs[p]["ranks"]:
        assert list(rank["groups"]) == [True, True, True]


@pytest.mark.parametrize("name", ["bs", "rs", "ring", "k7", "k7t"])
@pytest.mark.parametrize("p", PS_)
def test_process_products_match_jax(runs, p, name):
    """The batch- and row-sharded SpMMs and the ppermute ring against the
    JAX functions, both K7 rings (plain version) against the Pallas rings
    interpreted; C put together from the ranks' blocks."""
    want = runs[p]["jax"][name]
    got = _blocks(runs[p]["ranks"], name).reshape(want.shape)
    assert _rel(got, want) < TOL


@pytest.mark.parametrize("p", PS_)
def test_ring_on_the_model_axis_of_a_2d_mesh(runs, p):
    """The ring over each data index's model group of the (dp, tp) mesh:
    every group gives the JAX ring on a tp-device axis."""
    s, b = runs[p]["ops"]["ring"]
    dp, tp = train_mesh_shape(p)
    want = jsh.spmm_24_ring(s, b, JMesh(np.array(jax.devices()[:tp]),
                                        ("model",)), "model",
                            out_dtype=jnp.float32)
    for d in range(dp):
        got = _blocks(runs[p]["ranks"], "ring2d", _model_ranks(p, d))
        assert _rel(got.reshape(want.shape), want) < TOL


@pytest.mark.parametrize("key", ["ag_full", "ag_grad", "ag_data", "pmean",
                                 "pmean_bf16"])
@pytest.mark.parametrize("p", PS_)
def test_collectives_match_jax(runs, p, key):
    """``all_gather`` over ``model`` (and its gradient: JAX's
    ``psum_scatter`` transpose), over ``data`` along dim 1, and ``pmean``
    over ``data`` (f32) and ``model`` (bf16), rank by rank."""
    want = runs[p]["jax"][key]
    got = np.stack([r[key] for r in runs[p]["ranks"]])
    tol = 2e-2 if key == "pmean_bf16" else COLL_TOL
    assert _rel(got.reshape(want.shape), want) <= tol


@pytest.mark.parametrize("after", [1, worker.STEPS])
@pytest.mark.parametrize("p", PS_)
def test_train_step_matches_jax(runs, p, after):
    """The dp x tp step, one rank per process, against JAX's
    ``make_train_step`` on the same (dp, tp) mesh: losses, parameters
    (every data index's copy) within 1e-5, codes exactly."""
    jloss, jparams = runs[p]["steps"][after]
    ranks = runs[p]["ranks"]
    for rank in ranks:
        assert abs(float(rank[f"loss{after}"]) - jloss) <= \
            STEP_TOL * abs(jloss)
    for params in _assembled_params(ranks, p, f"step{after}"):
        for jl, tl in zip(jparams, params):
            for j, t in zip(jl, tl):
                assert _rel(t, j) <= STEP_TOL
            np.testing.assert_array_equal(tl[2], jl[2])


@pytest.mark.parametrize("p", PS_)
def test_unshard_params_gives_every_rank_the_whole(runs, p):
    want = _assembled_params(runs[p]["ranks"], p, f"step{worker.STEPS}")[0]
    for rank in runs[p]["ranks"]:
        for i, layer in enumerate(want):
            for j, t in enumerate(layer):
                np.testing.assert_array_equal(rank[f"whole_{i}_{j}"], t)


@pytest.mark.parametrize("p", PS_)
def test_train_step_scales_the_gradient_by_tp(runs, p):
    """As JAX's step (``tests/test_torch_models.py``), the process step
    moves each weight by ``tp * lr * dloss/dW``."""
    _, tp = train_mesh_shape(p)
    start = runs[p]["start"]
    inputs = runs[p]["inputs"]
    grads = jax.grad(jmlp.loss_fn, allow_int=True)(
        start, jnp.asarray(inputs["mlp_x"]), jnp.asarray(inputs["mlp_y"]),
        jmlp.MlpConfig(dims=DIMS, dtype="float32"))
    after = _assembled_params(runs[p]["ranks"], p, "step1")[0]
    num = den = 0.0
    for l0, l1, lg in zip(start, after, grads):
        for j in (0, 1, 3):
            d = np.asarray(l0[j], np.float64) - np.asarray(l1[j], np.float64)
            g = np.asarray(lg[j], np.float64)
            num += float((d * g).sum())
            den += worker.LR * float((g * g).sum())
    assert num / den == pytest.approx(tp, rel=1e-3)


def _one_process(p, name, ops):
    """The port's one-process mesh on ``["cpu"] * P`` on the same
    operands."""
    s, b = ops[name]
    q = sparse24_from_numpy(np.asarray(s.values0), np.asarray(s.values1),
                            np.asarray(s.codes), s.shape, device="cpu")
    tb = tensor_from_numpy(np.asarray(b), "cpu")
    axis = "data" if name == "bs" else "model"
    mesh = tmesh.make_mesh((p,), (axis,), devices=["cpu"] * p)
    f32 = torch.float32
    fn = {"bs": lambda: tsh.spmm_24_batch_sharded(q, tb, mesh, axis),
          "rs": lambda: tsh.spmm_24_row_sharded(q, tb, mesh, axis),
          "ring": lambda: tsh.spmm_24_ring(q, tb, mesh, axis,
                                           out_dtype=f32),
          "k7": lambda: trk.spmm_24_ring_explicit(q, tb, mesh, axis,
                                                  out_dtype=f32),
          "k7t": lambda: trk.spmm_24_ring_tiled(q, tb, mesh, axis,
                                                out_dtype=f32, m_tile=128)}
    return tensor_to_numpy(fn[name]())


@pytest.mark.parametrize("name", ["bs", "rs", "ring", "k7", "k7t"])
@pytest.mark.parametrize("p", PS_)
def test_process_mesh_matches_the_one_process_mesh(runs, p, name):
    want = _one_process(p, name, runs[p]["ops"])
    got = _blocks(runs[p]["ranks"], name).reshape(want.shape)
    assert _rel(got, want) <= SAME_TOL


@pytest.mark.parametrize("p", PS_)
def test_train_step_matches_the_one_process_mesh(runs, p):
    dp, tp = train_mesh_shape(p)
    inputs = runs[p]["inputs"]
    mesh = tmesh.make_mesh((dp, tp), ("data", "model"), devices=["cpu"] * p)
    step = tmlp.make_train_step(mesh, tmlp.MlpConfig(dims=DIMS,
                                                     dtype="float32"),
                                lr=worker.LR)
    params = mlp_params_from_numpy(
        [tuple(np.asarray(t) for t in layer) for layer in runs[p]["start"]],
        "cpu")
    for n in range(1, worker.STEPS + 1):
        loss, params = step(params, torch.from_numpy(inputs["mlp_x"]),
                            torch.from_numpy(inputs["mlp_y"]))
        for rank in runs[p]["ranks"]:
            assert abs(float(rank[f"loss{n}"]) - float(loss)) <= \
                SAME_TOL * abs(float(loss))
    got = _assembled_params(runs[p]["ranks"], p, f"step{worker.STEPS}")[0]
    for tl, gl in zip(params, got):
        for t, g in zip(tl, gl):
            assert _rel(g, tensor_to_numpy(t)) <= SAME_TOL


@pytest.mark.parametrize("p", PS_)
def test_config4_processes_holds_k7_to_the_ppermute_ring(runs, p):
    """Config 4's process mode (quick size): one point at P = the world
    size with the one-process point's keys, the same record on every rank
    (times are the slowest rank's), K7's rings within 1e-4 of the
    ppermute ring."""
    from sparsifyme_tpu_torch.bench import configs

    recs = [json.loads(str(r["config4"])) for r in runs[p]["ranks"]]
    assert all(rec == recs[0] for rec in recs)
    rec = recs[0]
    assert rec["backend"] == "gloo" and len(rec["points"]) == 1
    point = rec["points"][0]
    assert set(point) == set(configs._config4_point(1, 1, 1, 1, 1, 4, 1.0,
                                                    1.0))
    assert point["devices"] == p and point["batch"] == 2 * p
    assert point["ring_ms"] > 0 and point["ideal_ms"] > 0
    for ring in ("explicit_overlap_ring", "tiled_ring"):
        assert rec[ring]["max_rel_err_vs_ppermute"] <= TOL
    assert rec["ppermute_ring"]["max_rel_err_vs_plain"] <= TOL


def test_entry_runs_under_the_launcher_on_gloo(tmp_path):
    """``python -m torch.distributed.run ... -m sparsifyme_tpu_torch.entry
    --processes --quick --cpu`` on two CPU processes: rank 0's record, the
    losses falling, the process path equal to the one-process port and
    its rings to their plain version."""
    import os
    import subprocess
    import sys

    root = str(pathlib.Path(__file__).resolve().parents[1])
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [root] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node=2", "-m", "sparsifyme_tpu_torch.entry",
         "--processes", "--quick", "--cpu"],
        capture_output=True, text=True, timeout=240, env=env, cwd=tmp_path)
    lines = [ln for ln in proc.stdout.splitlines()
             if ln.startswith('{"processes"')]
    assert proc.returncode == 0 and len(lines) == 1, proc.stderr[-3000:]
    rec = json.loads(lines[0])["processes"]
    assert rec["world"] == 2 and rec["backend"] == "gloo"
    assert rec["train"]["mesh"] == {"data": 1, "model": 2}
    losses = rec["train"]["losses"]
    assert len(losses) == 10 and losses[-1] < losses[0]
    assert all(v == 0.0 for v in rec["max_err_vs_one_process"].values())
    assert rec["config4"]["explicit_err_vs_ppermute"] <= TOL
    assert rec["config4"]["ppermute_err_vs_plain"] <= TOL
    # bf16 rings against the plain f32 product rounded once to bf16
    for name in ("explicit", "tiled"):
        assert rec["rings_at_r"][f"{name}_err_vs_plain"] <= 2e-2
    assert len(rec["launches_by_rank"]) == 2


@pytest.mark.parametrize("run", ["start_processes", "configs", "entry"])
def test_process_runs_without_a_card_need_cpu(monkeypatch, run):
    """Without a card a run with one rank per process refuses to start
    unless ``--cpu`` asks for gloo ranks: it never moves to the CPU
    quietly."""
    from sparsifyme_tpu_torch import entry
    from sparsifyme_tpu_torch.bench import configs

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    call = {"start_processes": tmesh.start_processes,
            "configs": lambda: configs.main(["4", "--processes"]),
            "entry": entry.run_processes}[run]
    with pytest.raises(RuntimeError, match="--cpu"):
        call()


def test_start_processes_outside_a_launcher_raises(monkeypatch):
    for var in ("WORLD_SIZE", "MASTER_ADDR"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(RuntimeError, match="torch.distributed.run"):
        tmesh.start_processes(cpu=True)


# --------------------------------------------------------------------------
# init_distributed
# --------------------------------------------------------------------------

def _free_port():
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


def _init_job(tmp_path, url, env):
    procs = _spawn(worker.init_only, 2, tmp_path, url, env)
    return _join(procs, tmp_path, time.monotonic() + 90)


def test_init_distributed_reads_the_rank_from_the_environment(tmp_path):
    """A ``tcp://`` init with ``process_id=None``: each process's rank
    comes from ``RANK`` (torch itself refuses a rank of None)."""
    ranks = _init_job(tmp_path, f"tcp://127.0.0.1:{_free_port()}", {})
    assert [int(r["rank"]) for r in ranks] == [0, 1]
    assert all(int(r["world"]) == 2 and float(r["total"][0]) == 3.0
               for r in ranks)


def test_init_distributed_under_the_launcher_needs_no_arguments(tmp_path):
    """With the variables ``torch.distributed.run`` sets, no arguments."""
    env = {"WORLD_SIZE": 2, "LOCAL_RANK": "{rank}",
           "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": _free_port()}
    ranks = _init_job(tmp_path, None, env)
    assert [int(r["rank"]) for r in ranks] == [0, 1]
    assert all(int(r["world"]) == 2 and float(r["total"][0]) == 3.0
               for r in ranks)


def test_init_distributed_without_a_rank_raises(monkeypatch):
    monkeypatch.delenv("RANK", raising=False)
    with pytest.raises(ValueError, match="rank of this process"):
        tmesh.init_distributed("tcp://127.0.0.1:1", num_processes=2)
    assert not torch.distributed.is_initialized()


def test_init_distributed_without_a_launcher_is_a_noop(monkeypatch):
    for var in ("WORLD_SIZE", "MASTER_ADDR", "RANK"):
        monkeypatch.delenv(var, raising=False)
    tmesh.init_distributed()
    tmesh.init_distributed("tcp://127.0.0.1:1", num_processes=1)
    assert not torch.distributed.is_initialized()


def test_process_mesh_refuses_tensors_of_the_other_device_kind():
    """A process mesh of card ranks (NCCL) refuses a CPU tensor, one of
    CPU ranks (gloo) a CUDA one, before any collective."""
    def mesh(dev):
        devs = np.empty(2, dtype=object)
        devs[:] = [torch.device(dev)] * 2
        return tmesh.Mesh(devs, ("model",), process_index=0, groups={})

    class OnCard:  # what check reads of a CUDA tensor
        device = torch.device("cuda", 0)

    with pytest.raises(ValueError, match="cpu tensor on a process mesh of "
                                         "cuda ranks"):
        mesh("cuda:0").check("op", torch.zeros(2))
    with pytest.raises(ValueError, match="cuda tensor on a process mesh of "
                                         "cpu ranks"):
        mesh("cpu").check("op", OnCard())
    mesh("cpu").check("op", torch.zeros(2))
