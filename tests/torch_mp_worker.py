"""One rank of the gloo jobs of ``tests/test_torch_multiprocess.py``.

Each process hides any card (so the group is gloo on the CPU), sets
``RANK``, starts the group through ``init_distributed`` with a ``file://``
init and ``process_id=None``, loads the inputs the test wrote (numpy, made
from a seed and compressed by the JAX package), runs every op of the
port's process mesh on its blocks and writes them to ``rank<r>.npz``. A
failure writes its traceback to ``error<r>.txt`` and exits 1. Imports
torch, numpy and the port only.
"""

from __future__ import annotations

import json
import os
import pathlib
import traceback

import numpy as np

TIMEOUT_S = 45  # each collective's wait: a lost peer fails, never hangs
STEPS = 3
LR = 1e-2


def job(rank: int, world: int, workdir: str) -> None:
    """The spawn target: one rank's run, errors to ``error<rank>.txt``."""
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    os.environ["RANK"] = str(rank)
    work = pathlib.Path(workdir)
    try:
        _run(rank, world, work)
    except BaseException:
        (work / f"error{rank}.txt").write_text(traceback.format_exc())
        raise SystemExit(1)


def init_only(rank: int, world: int, workdir: str, url, env) -> None:
    """Start the group with ``init_distributed(url, world)`` (``url`` None:
    no arguments, under the launcher's variables ``env``), with
    ``RANK`` set and ``process_id`` None; all-reduce ``rank + 1`` and
    write the world size, rank and sum."""
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    os.environ["RANK"] = str(rank)
    os.environ.update({k: str(v).format(rank=rank) for k, v in env.items()})
    work = pathlib.Path(workdir)
    try:
        import torch
        import torch.distributed as dist

        from sparsifyme_tpu_torch.parallel.mesh import init_distributed

        if url is None:
            init_distributed(timeout_s=TIMEOUT_S)
        else:
            init_distributed(url, world, timeout_s=TIMEOUT_S)
        t = torch.tensor([float(rank + 1)])
        dist.all_reduce(t)
        np.savez(work / f"rank{rank}.npz", world=dist.get_world_size(),
                 rank=dist.get_rank(), total=t.numpy())
        dist.destroy_process_group()
    except BaseException:
        (work / f"error{rank}.txt").write_text(traceback.format_exc())
        raise SystemExit(1)


def _run(rank: int, world: int, work: pathlib.Path) -> None:
    import torch
    import torch.distributed as dist

    from sparsifyme_tpu_torch.bench.configs import config4_processes
    from sparsifyme_tpu_torch.containers import Sparse24
    from sparsifyme_tpu_torch.convert import (mlp_params_from_numpy,
                                              tensor_to_numpy)
    from sparsifyme_tpu_torch.entry import train_mesh_shape
    from sparsifyme_tpu_torch.models import sparse_mlp as tmlp
    from sparsifyme_tpu_torch.ops.sparse24 import pack_wg
    from sparsifyme_tpu_torch.parallel import collectives
    from sparsifyme_tpu_torch.parallel.mesh import (init_distributed,
                                                    make_mesh, shard)
    from sparsifyme_tpu_torch.parallel.ring_kernel import (
        spmm_24_ring_explicit, spmm_24_ring_tiled)
    from sparsifyme_tpu_torch.parallel.spmm_sharded import (
        pad_rows, shard_planes, spmm_24_batch_sharded, spmm_24_ring,
        spmm_24_row_sharded)

    torch.set_num_threads(1)  # six ranks share the test's few cores
    init_distributed(f"file://{work / 'init'}", world, timeout_s=TIMEOUT_S)
    inp = dict(np.load(work / "inputs.npz"))
    f32 = torch.float32

    def t(key):
        return torch.from_numpy(inp[key])

    def sparse(name):
        return Sparse24(t(f"{name}_v0"), t(f"{name}_v1"), t(f"{name}_codes"),
                        shape=tuple(int(d) for d in inp[f"{name}_shape"]))

    def k_shard(name, mesh, dtype=torch.float32):
        s = sparse(name)
        s = Sparse24(s.values0.to(dtype), s.values1.to(dtype), s.codes,
                     shape=s.shape)
        bp = pad_rows(t(f"{name}_b").to(dtype), 4 * s.values0.shape[0])
        return (shard_planes(s, mesh, "model")[0],
                shard(bp, ("model", None), mesh)[0])

    dp, tp = train_mesh_shape(world)
    mesh_m = make_mesh((world,), ("model",))
    mesh_d = make_mesh((world,), ("data",))
    mesh2 = make_mesh((dp, tp), ("data", "model"))
    out = {"devices": np.array([str(d) for d in mesh2.devices.flat])}
    # one process group per rank set, whichever mesh asks for it
    out["groups"] = np.array([
        make_mesh((world,), ("model",)).group("model") is
        mesh_m.group("model"),
        mesh_d.group("data") is dist.group.WORLD,
        make_mesh((dp, tp), ("data", "model")).group("data") is
        mesh2.group("data")])

    s = shard_planes(sparse("bs"), mesh_d, "data")[0]
    out["bs"] = spmm_24_batch_sharded(s, t("bs_b"), mesh_d, "data")
    s = shard_planes(sparse("rs"), mesh_m, "model")[0]
    out["rs"] = spmm_24_row_sharded(s, t("rs_b"), mesh_m, "model")
    s, b = k_shard("ring", mesh_m)
    out["ring"] = spmm_24_ring(s, b, mesh_m, "model", out_dtype=f32)
    s, b = k_shard("ring", mesh2)
    out["ring2d"] = spmm_24_ring(s, b, mesh2, "model", out_dtype=f32)
    s, b = k_shard("k7", mesh_m)
    out["k7"] = spmm_24_ring_explicit(s, b, mesh_m, "model", out_dtype=f32)
    s, b = k_shard("k7t", mesh_m)
    out["k7t"] = spmm_24_ring_tiled(s, b, mesh_m, "model", out_dtype=f32,
                                    m_tile=128)
    # K7's wgmma_sp step: bf16, the shard packed once after shard_planes
    bf16 = torch.bfloat16
    s, b = k_shard("k7wg", mesh_m, bf16)
    out["k7wg"] = spmm_24_ring_explicit(pack_wg(s), b, mesh_m, "model",
                                        out_dtype=bf16, design="wgmma_sp")
    s, b = k_shard("k7twg", mesh_m, bf16)
    out["k7twg"] = spmm_24_ring_tiled(pack_wg(s), b, mesh_m, "model",
                                      out_dtype=f32, m_tile=128,
                                      design="wgmma_sp")

    part = t("ag_x")[rank].clone().requires_grad_()
    full = collectives.all_gather([part], mesh2, "model")[0]
    (full * t("ag_ct")[rank]).sum().backward()
    out["ag_full"], out["ag_grad"] = full, part.grad
    out["ag_data"] = collectives.all_gather([t("ag_x")[rank]], mesh2, "data",
                                            dim=1)[0]
    out["pmean"] = collectives.pmean([t("pm_x")[rank]], mesh2, "data")[0]
    out["pmean_bf16"] = collectives.pmean(
        [t("pm_x")[rank].to(torch.bfloat16)], mesh2, "model")[0]

    start = [tuple(inp[f"mlp_{i}_{j}"] for j in range(4))
             for i in range(int(inp["mlp_layers"]))]
    config = tmlp.MlpConfig(dims=tuple(int(d) for d in inp["mlp_dims"]),
                            dtype="float32")
    step = tmlp.make_train_step(mesh2, config, lr=LR)
    params = tmlp.shard_params(mlp_params_from_numpy(start, "cpu"), mesh2)
    x = shard(t("mlp_x"), ("data", None), mesh2)[0]
    y = shard(t("mlp_y"), ("data", None), mesh2)[0]
    for n in range(STEPS):
        loss, params = step(params, x, y)
        out[f"loss{n + 1}"] = loss
        if n + 1 in (1, STEPS):
            for i, layer in enumerate(params):
                for j, p in enumerate(layer):
                    out[f"step{n + 1}_{i}_{j}"] = p
    whole = tmlp.unshard_params(params, mesh2)
    for i, layer in enumerate(whole):
        for j, p in enumerate(layer):
            out[f"whole_{i}_{j}"] = p

    out["config4"] = np.array(json.dumps(config4_processes(quick=True)))

    np.savez(work / f"rank{rank}.npz", **{
        k: v if isinstance(v, np.ndarray) else tensor_to_numpy(v)
        for k, v in out.items()})
    dist.barrier()
    dist.destroy_process_group()
