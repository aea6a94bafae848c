"""The plain reference: what each path must compute, worked out again from
the benchmark's own inputs, in plain PyTorch and float32.

Nothing here imports the program. The 2:4 selection, the Blocked-ELL block
selection and the products are derived anew from the dense inputs that the
benchmark made from its seed, on whatever device holds them, a block of
rows at a time.

The control (:func:`control_product`) is this reference put in the
program's place one precision down: the configurations state bf16 in,
float32 accumulation and bf16 out, so the control rounds both inputs to
fp8 (e4m3), accumulates in float32 and rounds its output to bf16.
"""

from __future__ import annotations

from typing import Tuple

import torch

ROW_BLOCK = 1 << 16


def _strict_f32() -> None:
    # a float32 product on the card may otherwise run in TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def keep_24(a: torch.Tensor) -> torch.Tensor:
    """``a [rows, k]`` with all but the two largest magnitudes of every
    group of 4 along k set to 0. The last group acts as zero-padded; of
    equal magnitudes the later position ranks higher."""
    return torch.cat([_keep_24_rows(a[i:i + ROW_BLOCK])
                      for i in range(0, a.shape[0], ROW_BLOCK)])


def _keep_24_rows(a: torch.Tensor) -> torch.Tensor:
    rows, k = a.shape
    k4 = -(-k // 4)
    mag = torch.nn.functional.pad(a.abs().float(), (0, 4 * k4 - k))
    mag = mag.view(rows, k4, 4)
    pos = torch.arange(4, device=a.device)
    # beats[..., j, i]: element j ranks above element i
    mj, mi = mag[..., :, None], mag[..., None, :]
    later = pos[:, None] > pos[None, :]
    beats = (mj > mi) | ((mj == mi) & later)
    keep = beats.sum(dim=-2) < 2
    keep = keep.view(rows, 4 * k4)[:, :k]
    return a * keep.to(a.dtype)


def ell_keep(a: torch.Tensor, block_size: int, block_k: int,
             blocks_kept: int) -> Tuple[torch.Tensor, float]:
    """``a [rows, kp]`` with only the ``blocks_kept`` blocks of largest
    Frobenius norm left in each block-row (norms in float64; of equal
    norms the lower block index first). Also returns the smallest relative
    gap between the last kept norm and the first dropped one over all
    block-rows: near 0, the selection hangs on rounding."""
    rows, kp = a.shape
    mb, kb = rows // block_size, kp // block_k
    blocks = a.view(mb, block_size, kb, block_k)
    norms = blocks.double().square().sum(dim=(1, 3))
    order = torch.sort(norms, dim=-1, descending=True, stable=True)
    keep = torch.zeros_like(norms, dtype=torch.bool)
    keep.scatter_(1, order.indices[:, :blocks_kept], True)
    if blocks_kept < kb:
        last = order.values[:, blocks_kept - 1]
        nxt = order.values[:, blocks_kept]
        margin = float(((last - nxt) / last.clamp_min(1e-300)).min())
    else:
        margin = 1.0
    kept = blocks * keep[:, None, :, None].to(a.dtype)
    return kept.view(rows, kp), margin


def product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in float32 (TF32 off), a block of rows at a time."""
    _strict_f32()
    bf = b.float()
    return torch.cat([a[i:i + ROW_BLOCK].float() @ bf
                      for i in range(0, a.shape[0], ROW_BLOCK)])


def control_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The control: both inputs rounded to fp8 e4m3, float32 accumulation,
    bf16 out."""
    _strict_f32()
    f8 = torch.float8_e4m3fn
    bq = b.to(f8).float()
    return torch.cat([(a[i:i + ROW_BLOCK].to(f8).float() @ bq).to(
        torch.bfloat16) for i in range(0, a.shape[0], ROW_BLOCK)])


def readings(c: torch.Tensor, ref: torch.Tensor) -> Tuple[float, float]:
    """``(rel_err, max_err)`` of an output ``c`` against the float32
    reference ``ref``: the Frobenius norm of the difference over the
    reference's, and the largest elementwise difference over the
    reference's root mean square. Any non-finite value or a shape that
    differs reads infinite."""
    if tuple(c.shape) != tuple(ref.shape):
        return float("inf"), float("inf")
    num = den = worst = 0.0
    for i in range(0, ref.shape[0], ROW_BLOCK):
        d = c[i:i + ROW_BLOCK].float() - ref[i:i + ROW_BLOCK]
        if not bool(torch.isfinite(d).all()):
            return float("inf"), float("inf")
        num += float(d.double().square().sum())
        den += float(ref[i:i + ROW_BLOCK].double().square().sum())
        worst = max(worst, float(d.abs().max()))
    rms = (den / ref.numel()) ** 0.5
    if den == 0.0:
        return (0.0, 0.0) if num == 0.0 else (float("inf"), float("inf"))
    return (num / den) ** 0.5, worst / rms
