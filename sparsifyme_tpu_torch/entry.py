"""Entry points of the port: a forward check of the flagship model and a
multi-rank dry run.

Counterparts of ``__graft_entry__.entry`` and ``dryrun_multichip`` at the
repository's root, on the port's mesh of ranks::

    python -m sparsifyme_tpu_torch.entry [n_ranks]   # needs a card
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from ._build import resolve_device
from .models.sparse_mlp import (MlpConfig, forward, init_params,
                                make_train_step)
from .ops.prune import prune_24
from .ops.sparse24 import compress_24
from .parallel.mesh import make_mesh
from .parallel.ring_kernel import spmm_24_ring_explicit, spmm_24_ring_tiled
from .parallel.spmm_sharded import spmm_24_ring

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


if __name__ == "__main__":
    import sys

    fn, args = entry()
    out = fn(*args)
    print("entry forward:", tuple(out.shape), out.dtype)
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1
                     else torch.cuda.device_count())
