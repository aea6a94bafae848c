"""The traffic's inputs, made on the device from the run's seed.

Every tensor comes from its own generator, seeded from ``(seed, what,
layer, rank)``, so a layer's inputs can be made again after the window for
the reference without keeping them, and every seed gives every layer the
same shapes. Values are drawn in the type they are served in (bf16).
"""

from __future__ import annotations

import hashlib

import torch


def stream_seed(seed: int, *parts) -> int:
    """A 63-bit seed for one tensor of one run."""
    h = hashlib.blake2b(repr((int(seed),) + parts).encode(), digest_size=8)
    return int.from_bytes(h.digest(), "little") >> 1


def _gen(device: torch.device, seed: int, *parts) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(stream_seed(seed,
                                                                  *parts))


def dense_a(rows: int, k: int, seed: int, layer: int, rank: int,
            device: torch.device) -> torch.Tensor:
    """A layer's dense A ``[rows, k]``: unit normal bf16."""
    return torch.randn((rows, k), generator=_gen(device, seed, "a", layer,
                                                 rank),
                       device=device, dtype=torch.bfloat16)


def weight_b(k: int, n: int, seed: int, layer: int,
             device: torch.device) -> torch.Tensor:
    """A layer's B ``[k, n]``, shared by every rank: unit normal bf16."""
    return torch.randn((k, n), generator=_gen(device, seed, "b", layer),
                       device=device, dtype=torch.bfloat16)


def block_scaled_a(rows: int, k: int, kp: int, block_size: int,
                   block_k: int, blocks_large: int, small_scale: float,
                   seed: int, layer: int, rank: int,
                   device: torch.device) -> torch.Tensor:
    """A layer's dense A for a block-sparse path, ``[rows, kp]`` with
    columns ``k:`` zero: unit normal values, and in each block-row all but
    ``blocks_large`` blocks (drawn from the seed among the blocks that hold
    columns of k) scaled by ``small_scale``. The blocks that a top-norm
    selection keeps then stand out by far more than any rounding of their
    norms."""
    a = torch.zeros((rows, kp), device=device, dtype=torch.bfloat16)
    a[:, :k] = dense_a(rows, k, seed, layer, rank, device)
    mb, kb = rows // block_size, kp // block_k
    real = -(-k // block_k)
    draw = torch.rand((mb, real), generator=_gen(device, seed, "m", layer,
                                                 rank), device=device)
    large = draw.topk(blocks_large, dim=1).indices
    scale = torch.full((mb, kb), small_scale, device=device,
                       dtype=torch.bfloat16)
    scale.scatter_(1, large, 1.0)
    a.view(mb, block_size, kb, block_k).mul_(scale[:, None, :, None])
    return a
