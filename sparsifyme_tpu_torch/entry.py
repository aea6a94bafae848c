"""Entry points of the port: a forward check of the flagship model, a
multi-rank dry run, and the run with one rank per process.

Counterparts of ``__graft_entry__.entry`` and ``dryrun_multichip`` at the
repository's root, on the port's mesh of ranks::

    python -m sparsifyme_tpu_torch.entry [n_ranks]   # needs a card
    python -m torch.distributed.run --standalone --nproc-per-node=P \
        -m sparsifyme_tpu_torch.entry --processes [--quick] [--cpu]

``--processes`` (:func:`run_processes`) runs one rank per process over
NCCL, one card per rank (with ``--cpu``, gloo ranks on the CPU): the dry
run's checks on the process mesh, config 4 at full size, ten steps of the
flagship MLP's dp x tp step and both K7 rings at the ResNet-scale shard
(bf16, each process's shard packed once with ``pack_wg``, so the rings
take K7's wgmma_sp step), each held to the one-process port on the same
seeds. Rank 0 prints one
``{"processes": ...}`` line; a failure on any rank exits 1, and the
launcher then stops the others and exits non-zero.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import sys
import tempfile
import time
import traceback
from typing import Optional, Sequence

import torch

from . import _build
from ._build import resolve_device
from .models.sparse_mlp import (MlpConfig, forward, init_params,
                                make_train_step, shard_params,
                                unshard_params)
from .ops.prune import prune_24, prune_nm
from .ops.kernels.spmm24_kernel import WG_BM
from .ops.sparse24 import compress_24, pack_wg, spmm_24
from .parallel.mesh import make_mesh, shard, shard_batch, start_processes
from .parallel.ring_kernel import spmm_24_ring_explicit, spmm_24_ring_tiled
from .parallel.spmm_sharded import pad_rows, shard_planes, spmm_24_ring

ENTRY_CONFIG = MlpConfig(dims=(256, 512, 512, 256), dtype="bfloat16")
ENTRY_BATCH = 128


def _normal(seed: int, shape, dtype, device) -> torch.Tensor:
    """Normal numbers from a CPU generator seeded ``seed``: the same on
    every device."""
    gen = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=gen).to(dtype).to(device)


def entry(device=None):
    """``(fn, args)``: the forward of the flagship model, a 2:4-sparse MLP
    running kernel K3 per layer, at its default config and batch 128, on
    ``device`` (default: the card)."""
    dev = resolve_device(device)
    config = ENTRY_CONFIG
    params = init_params(config, torch.Generator().manual_seed(0), dev)
    x = _normal(1, (ENTRY_BATCH, config.dims[0]), config.torch_dtype, dev)

    def fn(params, x):
        return forward(params, x, config)

    return fn, (params, x)


def _devices(n: int, devices: Optional[Sequence]):
    if devices is not None:
        if len(devices) != n:
            raise ValueError(f"{len(devices)} devices for {n} ranks")
        return list(devices)
    resolve_device(None)  # raises without a card
    cards = torch.cuda.device_count()
    return [f"cuda:{r % cards}" for r in range(n)]


def dryrun_multichip(n_devices: int, devices: Optional[Sequence] = None):
    """One step of the whole SPMD train step (dp x tp: batch-sharded data,
    row-sharded 2:4 weights, all-gather and gradient mean) over
    ``n_devices`` ranks at tiny shapes, then the three ring SpMMs on them,
    each held against a dense product of the pruned operand at 1e-4.

    ``devices`` defaults to the cards, round-robin (``["cuda:0"] * n`` on
    one card, a rank per card on ``n``); ``["cpu"] * n`` runs the plain
    versions. Returns the step's loss."""
    devs = _devices(n_devices, devices)
    home = torch.device(devs[0])
    # Two axes when possible: data-parallel batch x tensor-parallel rows.
    dp = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    tp = n_devices // dp
    mesh = make_mesh((dp, tp), ("data", "model"), devices=devs)

    # dims divisible by tp (row-sharded d_out) and by 4 (2:4 groups).
    d = max(8 * tp, 32)
    f32 = torch.float32
    config = MlpConfig(dims=(d, 2 * d, d), dtype="float32")
    params = init_params(config, torch.Generator().manual_seed(0), home)
    batch = 4 * dp
    x = _normal(1, (batch, d), f32, home)
    y = _normal(2, (batch, d), f32, home)
    step = make_train_step(mesh, config, lr=1e-2)
    loss, new_params = step(params, x, y)
    loss = float(loss)
    if loss != loss:
        raise AssertionError("loss is NaN")

    # The ring exchange on BATCHED inputs (BASELINE config 4's case)
    # against the dense product.
    bsz, m_r, k_r, n_r = 2 * tp, 8, 16 * tp, 16
    a_r = _normal(3, (bsz, m_r, k_r), f32, home)
    b_r = _normal(4, (k_r, n_r), f32, home)
    pruned_r, _ = prune_24(a_r)
    s_r = compress_24(pruned_r)
    want = torch.einsum("bmk,kn->bmn", pruned_r, b_r)
    ring = spmm_24_ring(s_r, b_r, mesh, axis="model", out_dtype=f32)
    torch.testing.assert_close(ring, want, rtol=1e-4, atol=1e-4)

    # K7's explicit ring and its tiled ring (several m-tiles per shard, so
    # the credits cross tiles) on the model axis's ranks.
    mesh1 = make_mesh((tp,), ("model",), devices=devs[:tp])
    ring2 = spmm_24_ring_explicit(s_r, b_r, mesh1, axis="model",
                                  out_dtype=f32)
    torch.testing.assert_close(ring2, want, rtol=1e-4, atol=1e-4)
    mt = 128
    m_t, k_t, n_t = mt * tp * 2, 16 * tp, 16
    pruned_t, _ = prune_24(_normal(5, (m_t, k_t), f32, home))
    s_t = compress_24(pruned_t)
    b_t = _normal(6, (k_t, n_t), f32, home)
    ring3 = spmm_24_ring_tiled(s_t, b_t, mesh1, axis="model", out_dtype=f32,
                               m_tile=mt)
    torch.testing.assert_close(ring3, torch.matmul(pruned_t, b_t),
                               rtol=1e-4, atol=1e-4)

    print(f"dryrun_multichip({n_devices}): mesh={dict(mesh.shape)} "
          f"loss={loss:.4f} ring-batched OK rdma-ring OK "
          "rdma-ring-tiled OK")
    return loss


# --------------------------------------------------------------------------
# One rank per process
# --------------------------------------------------------------------------

TRAIN_STEPS = 10
TRACED_STEPS = 3  # the last steps, traced on rank 0 for the busy share
# m, n, k and batch of the ResNet-scale shard K7's rings run at: 25088
# folded rows, 6272 x 1024 per rank at P = 4
RING = (784, 256, 1024, 32)
RING_QUICK = (196, 256, 1024, 8)
# the counters of the kernels on this path, by the names chip_smoke uses
ROUTES = ("prune_nm", "compress_24", "spmm_24", "ring_step",
          "ring_step_tiled", "ring_step_wg", "ring_step_wg_tiled")


def _wrappers():
    from .ops.kernels import prune_kernel, spmm24_kernel
    from .parallel import ring_kernel
    return dict(zip(ROUTES, (
        prune_kernel.prune_nm_cuda, prune_kernel.compress_24_cuda,
        spmm24_kernel.spmm24_cuda, ring_kernel.ring_step_cuda,
        ring_kernel.ring_step_tiled_cuda, ring_kernel.ring_step_wg_cuda,
        ring_kernel.ring_step_wg_tiled_cuda)))


def _packed(s):
    """``s`` with K7's wgmma_sp operand packed once where its planes' width
    is whole 128-row tiles (the rings then take that step), else ``s``."""
    return pack_wg(s) if s.values0.shape[-1] % WG_BM == 0 else s


def train_mesh_shape(world: int):
    """(dp, tp) of the train step at ``world`` processes: 1 x 1, 1 x 2,
    2 x 2, then 2 x world/2."""
    return (2, world // 2) if world >= 4 and world % 2 == 0 else (1, world)


def _rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.float(), want.float()
    return float((got - want).abs().max() / (want.abs().max() + 1e-30))


def _max_over_ranks(x: float, device) -> float:
    import torch.distributed as dist

    t = torch.tensor([x], dtype=torch.float64, device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return float(t)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def dryrun_processes() -> float:
    """:func:`dryrun_multichip`'s checks with one rank per process: one
    step of the train step on the (dp, tp) process mesh, the ppermute ring
    on its model axis, and K7's two rings on a 1-D mesh of every process,
    each held against a dense product of the pruned operand at 1e-4 on the
    rank's block. Every process must call it; returns the step's loss."""
    import torch.distributed as dist

    n = dist.get_world_size()
    dp, tp = train_mesh_shape(n)
    mesh = make_mesh((dp, tp), ("data", "model"))
    dev = mesh.device
    d = max(8 * tp, 32)
    f32 = torch.float32
    config = MlpConfig(dims=(d, 2 * d, d), dtype="float32")
    params = init_params(config, torch.Generator().manual_seed(0), dev)
    x = _normal(1, (4 * dp, d), f32, dev)
    y = _normal(2, (4 * dp, d), f32, dev)
    step = make_train_step(mesh, config, lr=1e-2)
    loss, _ = step(shard_params(params, mesh), shard_batch(x, mesh)[0],
                   shard_batch(y, mesh)[0])
    loss = float(loss)
    if loss != loss:
        raise AssertionError("loss is NaN")

    def blocks(s, b, want, mesh_):
        """This rank's planes, k-shard of B and rows of ``want``."""
        bp = pad_rows(b, 4 * s.values0.shape[0])
        return (shard_planes(s, mesh_, "model")[0],
                shard(bp, ("model", None), mesh_)[0],
                shard(want.reshape(-1, b.shape[-1]), ("model", None),
                      mesh_)[0])

    bsz, m_r, k_r, n_r = 2 * tp, 8, 16 * tp, 16
    pruned_r, _ = prune_24(_normal(3, (bsz, m_r, k_r), f32, dev))
    s_r = compress_24(pruned_r)
    b_r = _normal(4, (k_r, n_r), f32, dev)
    want = torch.einsum("bmk,kn->bmn", pruned_r, b_r)
    s_blk, b_blk, want_blk = blocks(s_r, b_r, want, mesh)
    ring = spmm_24_ring(s_blk, b_blk, mesh, axis="model", out_dtype=f32)
    torch.testing.assert_close(ring.reshape(want_blk.shape), want_blk,
                               rtol=1e-4, atol=1e-4)

    mesh1 = make_mesh((n,), ("model",))
    s_blk, b_blk, want_blk = blocks(s_r, b_r, want, mesh1)
    ring2 = spmm_24_ring_explicit(s_blk, b_blk, mesh1, axis="model",
                                  out_dtype=f32)
    torch.testing.assert_close(ring2.reshape(want_blk.shape), want_blk,
                               rtol=1e-4, atol=1e-4)
    mt = 128
    pruned_t, _ = prune_24(_normal(5, (mt * n * 2, 16 * tp), f32, dev))
    b_t = _normal(6, (16 * tp, 16), f32, dev)
    s_blk, b_blk, want_blk = blocks(compress_24(pruned_t), b_t,
                                    torch.matmul(pruned_t, b_t), mesh1)
    ring3 = spmm_24_ring_tiled(s_blk, b_blk, mesh1, axis="model",
                               out_dtype=f32, m_tile=mt)
    torch.testing.assert_close(ring3, want_blk, rtol=1e-4, atol=1e-4)
    if dist.get_rank() == 0:
        print(f"dryrun_processes({n}): mesh={dict(mesh.shape)} "
              f"loss={loss:.4f} ring-batched OK rdma-ring OK "
              "rdma-ring-tiled OK", flush=True)
    return loss


def _train(world: int, dev: torch.device):
    """Ten steps of the flagship MLP's dp x tp step (256-512-512-256,
    batch 128, bf16) on the process mesh; the parameters stay sharded.
    ``step_ms`` is the median of steps 2-7 (host clock, synchronised);
    rank 0 traces steps 8-10 for the card's busy share. Returns the
    record, the mesh, the whole inputs (for the one-process port) and this
    rank's final slabs."""
    import torch.distributed as dist

    from .utils.trace import busy_share, profile_trace

    dp, tp = train_mesh_shape(world)
    mesh = make_mesh((dp, tp), ("data", "model"))
    config = ENTRY_CONFIG
    whole = init_params(config, torch.Generator().manual_seed(0), dev)
    gen = torch.Generator().manual_seed(3)
    x = torch.randn((ENTRY_BATCH, config.dims[0]), generator=gen)
    y = (x @ (0.1 * torch.randn((config.dims[0], config.dims[-1]),
                                generator=gen)))
    x, y = x.to(config.torch_dtype).to(dev), y.to(config.torch_dtype).to(dev)
    step = make_train_step(mesh, config, lr=1e-2)
    params = shard_params(whole, mesh)
    xs, ys = shard_batch(x, mesh)[0], shard_batch(y, mesh)[0]
    losses, times = [], []

    def run(steps):
        nonlocal params
        for _ in range(steps):
            t0 = time.perf_counter()
            loss, params = step(params, xs, ys)
            _sync(dev)
            times.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(loss))

    run(TRAIN_STEPS - TRACED_STEPS)
    share = None
    if dev.type == "cuda" and dist.get_rank() == 0:
        with tempfile.TemporaryDirectory() as tmp:
            with profile_trace(tmp) as prof:
                run(TRACED_STEPS)
        share = busy_share(prof)
    else:
        run(TRACED_STEPS)
    record = {"mesh": dict(mesh.shape), "losses": losses,
              "step_ms": statistics.median(
                  times[1:TRAIN_STEPS - TRACED_STEPS]),
              "step_ms_all": times, "busy_share": share}
    return record, mesh, (whole, x, y), params


def _rings(world: int, dev: torch.device, quick: bool):
    """K7's two rings at the ResNet-scale shard on a 1-D mesh of every
    process (bf16): this rank's 25088 / P rows of A, pruned and compressed
    on its card, and its k-shard of B."""
    from .utils.timing import time_kernel

    m, n, k, batch = RING_QUICK if quick else RING
    mesh = make_mesh((world,), ("model",))
    gen = torch.Generator(device=dev).manual_seed(11)
    a = torch.randn((batch, m, k), generator=gen, device=dev).to(
        torch.bfloat16)
    b = torch.randn((k, n), generator=gen, device=dev).to(torch.bfloat16)
    # this rank's batch elements: compressed, they are its block of planes
    s = _packed(compress_24(prune_nm(shard(a, ("model", None, None),
                                           mesh)[0], 2, 4)[0]))
    b_blk = shard(pad_rows(b, 4 * s.values0.shape[0]), ("model", None),
                  mesh)[0]
    out, split = {}, {}
    for name, fn in (("explicit", spmm_24_ring_explicit),
                     ("tiled", spmm_24_ring_tiled)):
        def ring(ss, bb, fn=fn):
            return fn(ss, bb, mesh, "model", out_dtype=torch.bfloat16)

        got = ring(s, b_blk)
        ms = time_kernel(ring, (s, b_blk), iters=10, reps=3).ms
        out[name] = (got, _max_over_ranks(ms, dev))
        split[name] = _ring_split(ring, (s, b_blk), dev)
    return out, split, mesh, (s, a, b)


def _ring_split(ring, ops, dev, calls: int = 5) -> dict:
    """Where a process ring's time goes, per call: the host's time to
    queue it (no wait for the card; the slowest rank's), and on rank 0's
    card the device time of K7's kernels and of NCCL's (``torch.profiler``;
    an NCCL kernel's time includes its wait for the peer)."""
    import torch.distributed as dist
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    _sync(dev)
    dist.barrier()
    t0 = time.perf_counter()
    for _ in range(calls):
        ring(*ops)
    enqueue = (time.perf_counter() - t0) * 1e3 / calls
    _sync(dev)
    split = {"enqueue_ms": _max_over_ranks(enqueue, dev)}
    if dev.type != "cuda" or dist.get_rank() != 0:
        for _ in range(calls):
            ring(*ops)
        _sync(dev)
        return split
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            ring(*ops)
        _sync(dev)
    device = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    for key, what in (("k7_device_ms", "ring24"), ("nccl_device_ms", "nccl")):
        split[key] = sum(e.self_device_time_total for e in device
                         if what in e.key.lower()) / 1e3 / calls
    return split


def run_processes(quick: bool = False, cpu: bool = False) -> dict:
    """The run with one rank per process (module docstring); every process
    of a ``torch.distributed.run`` job calls it. Launch counters are set to
    0 just before the path and read just after it, before the comparisons
    with the one-process port. Returns rank 0's record (other ranks: an
    empty dict); raises on any failed check."""
    import torch.distributed as dist

    from .bench.configs import config4_processes, plain_block

    start_processes(cpu=cpu)
    world, rank = dist.get_world_size(), dist.get_rank()
    dev = (torch.device("cuda", torch.cuda.current_device())
           if dist.get_backend() == "nccl" else torch.device("cpu"))
    if dev.type == "cuda":
        if rank == 0:
            _build.build_all()
        dist.barrier()
    wrappers = _wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    t0 = time.perf_counter()
    dry_loss = dryrun_processes()
    c4 = config4_processes(quick=quick)
    train, mesh2, (whole, x, y), params = _train(world, dev)
    rings, ring_split, mesh1, (s, a, b) = _rings(world, dev, quick)
    launches = {name: fn.launches for name, fn in wrappers.items()}
    path_s = time.perf_counter() - t0

    # the path's checks and the one-process port on the same seeds
    got_whole = unshard_params(params, mesh2)
    one = make_train_step(
        make_mesh(mesh2.devices.shape, ("data", "model"),
                  devices=[dev] * world), ENTRY_CONFIG, lr=1e-2)
    ref, times = whole, []
    for _ in range(TRAIN_STEPS):
        t1 = time.perf_counter()
        _, ref = one(ref, x, y)
        _sync(dev)
        times.append((time.perf_counter() - t1) * 1e3)
    # the one-process step, its P ranks sharing this process's device
    train["one_process_step_ms"] = statistics.median(times[1:])
    errs = {"train_params": max(
        _rel_err(g, w) for gl, wl in zip(got_whole, ref)
        for g, w in zip(gl, wl))}
    codes_equal = all(torch.equal(gl[2], wl[2])
                      for gl, wl in zip(got_whole, ref))
    s_whole_mesh = make_mesh((world,), ("model",), devices=[dev] * world)
    vs_spmm, vs_plain = {}, {}
    plain = plain_block(s, b, torch.bfloat16)
    for name, (got, _) in rings.items():
        vs_spmm[name] = _rel_err(got, spmm_24(s, b,
                                              out_dtype=torch.bfloat16))
        vs_plain[name] = _rel_err(got, plain)
    # the one-process ring at P ranks on this card, on the whole operand
    n = b.shape[-1]
    s_all = _packed(compress_24(prune_nm(a, 2, 4)[0]))
    for name, fn in (("explicit", spmm_24_ring_explicit),
                     ("tiled", spmm_24_ring_tiled)):
        want = shard(fn(s_all, b, s_whole_mesh, "model",
                        out_dtype=torch.bfloat16).reshape(-1, n),
                     ("model", None), mesh1)[0]
        errs[f"ring_{name}"] = _rel_err(rings[name][0].reshape(-1, n), want)
    errs = {key: _max_over_ranks(v, dev) for key, v in errs.items()}
    vs_spmm = {key: _max_over_ranks(v, dev) for key, v in vs_spmm.items()}
    vs_plain = {key: _max_over_ranks(v, dev) for key, v in vs_plain.items()}

    gathered = [None] * world
    dist.all_gather_object(gathered, {"launches": launches,
                                      "device": str(dev),
                                      "codes_equal": codes_equal})
    losses = train["losses"]
    failures = []
    if not all(map(math.isfinite, losses)) or losses[-1] >= losses[0]:
        failures.append(f"losses {losses}")
    if not all(g["codes_equal"] for g in gathered):
        failures.append("codes differ from the one-process step")
    tol = 2e-2  # bf16 products and updates, as the port's bf16 checks
    for key, v in {**errs,
                   **{f"{k}_vs_spmm_24": v for k, v in vs_spmm.items()},
                   **{f"{k}_vs_plain": v for k, v in vs_plain.items()}
                   }.items():
        if not v <= tol:
            failures.append(f"{key}: error {v} > {tol}")
    # config 4 runs in f32: the f32 tolerance of the port's checks
    if not c4["ppermute_ring"]["max_rel_err_vs_plain"] <= 1e-4:
        failures.append(f"config 4 ppermute_ring: {c4['ppermute_ring']}")
    for ring in ("explicit_overlap_ring", "tiled_ring"):
        if not c4[ring]["max_rel_err_vs_ppermute"] <= 1e-4:
            failures.append(f"config 4 {ring}: {c4[ring]}")
    if failures:
        raise AssertionError("; ".join(failures))
    if rank != 0:
        return {}
    return {"processes": {
        "world": world, "backend": dist.get_backend(),
        "devices": [g["device"] for g in gathered],
        "note": ("P >= 2 needs one card per process (NCCL refuses two "
                 "ranks on one card)"),
        "path_s": path_s,
        "dryrun_loss": dry_loss,
        "config4": c4["points"][0] | {
            "ppermute_err_vs_plain":
                c4["ppermute_ring"]["max_rel_err_vs_plain"],
            "explicit_err_vs_ppermute":
                c4["explicit_overlap_ring"]["max_rel_err_vs_ppermute"],
            "tiled_err_vs_ppermute":
                c4["tiled_ring"]["max_rel_err_vs_ppermute"]},
        "train": train,
        "rings_at_r": {
            "shape": dict(zip(("m", "n", "k", "batch"),
                              RING_QUICK if quick else RING)),
            **{f"{name}_ms": ms for name, (_, ms) in rings.items()},
            **{f"{name}_split": v for name, v in ring_split.items()},
            **{f"{name}_err_vs_spmm_24": v for name, v in vs_spmm.items()},
            **{f"{name}_err_vs_plain": v for name, v in vs_plain.items()}},
        "max_err_vs_one_process": errs,
        "launches_by_rank": [g["launches"] for g in gathered],
    }}


def _main_processes(quick: bool, cpu: bool) -> int:
    import torch.distributed as dist

    try:
        result = run_processes(quick=quick, cpu=cpu)
        if result:
            print(json.dumps(result), flush=True)
        dist.barrier()
        dist.destroy_process_group()
        return 0
    except BaseException:
        traceback.print_exc()
        sys.stderr.flush()
        # leave at once: the launcher stops the ranks still waiting on us
        os._exit(1)


if __name__ == "__main__":
    if "--processes" in sys.argv[1:]:
        sys.exit(_main_processes("--quick" in sys.argv[1:],
                                 "--cpu" in sys.argv[1:]))
    fn, args = entry()
    out = fn(*args)
    print("entry forward:", tuple(out.shape), out.dtype)
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1
                     else torch.cuda.device_count())
