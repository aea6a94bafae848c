"""Probes of K3's 2:4 tile: its feed and its MMAs apart, at two ring depths.

Port of ``experiments/units.py``, which asks whether a TPU overlaps the
2:4 expansion of A (VPU) with the dot (MXU) in one kernel body. Here the
question is what bounds K3's sparse tensor-core tile
(``csrc/sp24_tile.cuh``): the kernels are that tile with a compile-time
mode and ring depth (``csrc/sp24_units.cu``), so the times come from the
code that K3 and K7 run.

=========  ==========================  ====================================
JAX mode   here (mode, stages)         what runs
=========  ==========================  ====================================
expand     ``("feed", 4)``, ``2``      every k-step's loads of A's planes,
                                       codes and B, and its metadata; no
                                       ``mma.sp``
dot        ``("mma", 4)``, ``2``       the MMAs of every k-step on slot
                                       ``kt % stages``; no loads
both       ``("full", 4)``             K3's tile (the product)
parity     ``("full", 2)``             K3's tile on a two-slot ring
chain      ``("full", 1)``             a serial ring: load, wait, MMA
fp1        :func:`fp1_cuda`            A expanded into a dense tile in
                                       shared memory, then the dense
                                       tensor-core product
=========  ==========================  ====================================

What each computes, on planes ``v0, v1, codes [k4, M]`` and ``b [k, n]``
(bf16; the tile ``bm x bn`` of ``spmm24_kernel.pick_tile``):

* ``full``: ``C = A @ b``, as :func:`~..ops.kernels.spmm24_kernel.spmm24_plain`.
* ``feed``: every row of block ``i`` (rows ``i*bm ..``) gets ``sum over g
  of v0[g, i*bm] + v1[g, i*bm]`` (the sum over k of the block's first row
  of A, as the JAX ``expand`` writes it), in f32 and then bf16; and
  ``side[j, i]``, one uint32 word a block (as int32), is the XOR of every
  metadata word the block built (``spmm24_kernel.meta_words``), so that
  neither the loads nor the metadata are dead code.
* ``mma``: ``C = sum over kt < KT of A_s @ b_s`` with ``s = kt % stages``
  (``KT = ceil(k / 64)``; ``A_s``, ``b_s``: k-step ``s``'s 64 columns of A
  and rows of b), the only k-steps it staged.
* ``fp1``: ``out[m, n] = sum over q, g of A[m, 4g + q] * b[q*k4 + g, n]``:
  ``run_probe_fp1``'s product, whose slab holds A's k axis quarter-major.
  :func:`fp1_operand` permutes b once into ``b'[4g + q] = b[q*k4 + g]``,
  and the kernel computes ``A @ b'``.

The JAX ``dot``, ``both``, ``parity`` and ``chain`` multiply scratch that
nothing wrote, so JAX defines no output for them; their counterparts here
are held to their own plain versions only. ``expand`` and ``fp1`` are held
to the JAX kernels (``tests/test_torch_units_probe.py``).

A measurement module: the port does not import it. The CUDA wrappers
launch their kernel or raise; the tests call the plain versions.

Usage: python -m sparsifyme_tpu_torch.bench.units_probe   (needs one GPU)
"""

from __future__ import annotations

import collections
import subprocess
import sys
from typing import Dict, Tuple, Union

import torch

from .. import _build
from ..ops.kernels import spmm24_kernel as k3

MODES = {"full": 0, "feed": 1, "mma": 2}
# the (mode, stages) pairs csrc/sp24_units.cu builds
VARIANTS = (("full", 4), ("full", 2), ("full", 1), ("feed", 4), ("feed", 2),
            ("mma", 4), ("mma", 2))
KS = 64  # logical k of one stage of the tile
# m x n x k (b = 32 folded into m): the JAX probe's three shapes, then E and
# D of PERF.md, where K3 loses to the dense product
SHAPES = [(100352, 128, 512), (25088, 256, 1024), (401408, 64, 576),
          (401408, 256, 64), (6272, 512, 4608)]


def _validate(v0, v1, codes, b, what):
    if not v0.is_cuda or any(t.device != v0.device for t in (v1, codes, b)):
        raise ValueError(f"{what} needs CUDA tensors on one card")
    if v0.dtype != torch.bfloat16 or v1.dtype != torch.bfloat16 or \
            b.dtype != torch.bfloat16 or codes.dtype != torch.uint8:
        raise TypeError(f"{what} takes bf16 planes and b, uint8 codes")
    k4, m = v0.shape
    k, n = b.shape
    if v1.shape != v0.shape or codes.shape != v0.shape or k > 4 * k4:
        raise ValueError(f"{what}: planes {tuple(v0.shape)}, codes "
                         f"{tuple(codes.shape)}, b {tuple(b.shape)}")
    if m % 8 or n % 8:
        raise ValueError(f"{what} needs M and N multiples of 8, got {m}, {n}")
    return k4, m, k, n


def units_tile(v0: torch.Tensor, b: torch.Tensor) -> Tuple[int, int]:
    """``(bm, bn)``: the tile :func:`units_cuda` launches on these
    operands, :func:`~..ops.kernels.spmm24_kernel.card_tile`'s."""
    return k3.SP_TILES[k3.card_tile(v0.device, v0.shape[1], b.shape[1],
                                    b.shape[0])]


def units_cuda(v0, v1, codes, b, *, mode: str, stages: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the sparse tile in ``mode`` with a ``stages``-deep ring on
    CUDA tensors, on the tile of :func:`units_tile`; returns ``(out [M, n]
    bf16, side [ceil(n/bn), ceil(M/bm)] int32)``."""
    if (mode, stages) not in VARIANTS:
        raise ValueError(f"({mode!r}, {stages}) is not one of {VARIANTS}")
    k4, m, k, n = _validate(v0, v1, codes, b, "units_cuda")
    tile = k3.card_tile(v0.device, m, n, k)
    bm, bn = k3.SP_TILES[tile]
    v0, v1, codes, b = (t.contiguous() for t in (v0, v1, codes, b))
    out = torch.empty((m, n), dtype=torch.bfloat16, device=v0.device)
    side = torch.empty((-(-n // bn), -(-m // bm)), dtype=torch.int32,
                       device=v0.device)  # the kernel writes every word
    # (v0, v1, codes, b, out, side, M, N, K, K4, mode, stages, tile,
    #  device, stream)
    launch = _build.load("sp24_units", "units24_launch",
                         "pppppp" "iiii" "iiii" "p")
    _build.check(launch(
        v0.data_ptr(), v1.data_ptr(), codes.data_ptr(), b.data_ptr(),
        out.data_ptr(), side.data_ptr(), m, n, k, k4, MODES[mode], stages,
        tile, _build.device_index(v0), _build.stream_ptr(v0)),
        f"units_cuda({mode}, {stages})")
    units_cuda.launches[(mode, stages)] += 1
    return out, side


units_cuda.launches = collections.Counter()  # by (mode, stages)


def _xor_halves(w: torch.Tensor) -> torch.Tensor:
    """XOR over the last axis (a power of two long)."""
    while w.shape[-1] > 1:
        h = w.shape[-1] // 2
        w = w[..., :h] ^ w[..., h:]
    return w[..., 0]


def meta_xor(codes: torch.Tensor, k: int, bm: int) -> torch.Tensor:
    """The XOR of the metadata words a block of ``bm`` rows builds over the
    ``ceil(k / 64)`` k-steps, per block ``[ceil(M/bm)]`` int64, from the
    plain ``build_meta`` (``spmm24_kernel.meta_words``); rows past M are
    zero bytes, as the kernel stages them."""
    k4, m = codes.shape
    nb = -(-m // bm)
    c = torch.zeros((k4, nb * bm), dtype=torch.uint8)
    c[:, :m] = codes.cpu()
    acc = torch.zeros(nb, dtype=torch.int64)
    for kt in range(-(-k // KS)):
        words = k3.meta_words(k3.staged_codes(c, k4, False, kt), k4, False,
                              kt)  # [2, nb * bm/16, 8, 2]
        words = words.reshape(2, nb, bm // 16, 16).permute(1, 0, 2, 3)
        acc ^= _xor_halves(words.reshape(nb, -1))
    return acc


def units_plain(v0, v1, codes, b, *, mode: str, stages: int, bm: int,
                bn: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`units_cuda` on a ``bm x bn`` tile (the
    module docstring says what each mode computes)."""
    if (mode, stages) not in VARIANTS:
        raise ValueError(f"({mode!r}, {stages}) is not one of {VARIANTS}")
    k4, m = v0.shape
    k, n = b.shape
    kt_n = -(-k // KS)
    side = torch.zeros((-(-n // bn), -(-m // bm)), dtype=torch.int32,
                       device=v0.device)
    if mode == "full":
        return k3.spmm24_plain(v0, v1, codes, b, k_logical=k,
                               out_dtype=torch.bfloat16), side
    if mode == "feed":
        g = min(k4, kt_n * KS // 4)
        first = (v0[:g, ::bm].float() + v1[:g, ::bm].float()).sum(0)
        out = first.repeat_interleave(bm)[:m, None].expand(m, n)
        words = meta_xor(codes, k, bm)
        words = (words + 2 ** 31) % 2 ** 32 - 2 ** 31  # the uint32 bits
        side[:] = words.to(torch.int32).to(v0.device)[None, :]
        return out.to(torch.bfloat16).contiguous(), side
    a_t = torch.zeros((kt_n * KS, m), dtype=torch.float32, device=v0.device)
    full = k3.expand_planes(v0, v1, codes).float()
    a_t[:min(full.shape[0], kt_n * KS)] = full[:kt_n * KS]
    bp = torch.zeros((kt_n * KS, n), dtype=torch.float32, device=b.device)
    bp[:k] = b.float()
    acc = torch.zeros((m, n), dtype=torch.float32, device=v0.device)
    for s in range(min(stages, kt_n)):
        times = (kt_n - s + stages - 1) // stages  # k-steps on slot s
        ks = slice(s * KS, (s + 1) * KS)
        acc += times * (a_t[ks].T @ bp[ks])
    return acc.to(torch.bfloat16), side


def fp1_operand(b: torch.Tensor) -> torch.Tensor:
    """``b'[4g + q] = b[q*k4 + g]`` for ``b [4*k4, n]``: the rows of b in
    the order in which the expand-then-dense tile reads A's k axis."""
    k, n = b.shape
    if k % 4:
        raise ValueError(f"b needs 4*k4 rows, got {k}")
    return b.reshape(4, k // 4, n).permute(1, 0, 2).reshape(k, n)


def fp1_cuda(v0, v1, codes, bp) -> torch.Tensor:
    """Launch the expand-then-dense tile: ``A @ bp`` in bf16 with ``bp =
    fp1_operand(b)``, which :func:`fp1_plain` computes from ``b``."""
    k4, m, k, n = _validate(v0, v1, codes, bp, "fp1_cuda")
    v0, v1, codes, bp = (t.contiguous() for t in (v0, v1, codes, bp))
    out = torch.empty((m, n), dtype=torch.bfloat16, device=v0.device)
    # (v0, v1, codes, b, out, M, N, K, K4, device, stream)
    launch = _build.load("sp24_units", "fp1_launch", "ppppp" "iiii" "i" "p")
    _build.check(launch(
        v0.data_ptr(), v1.data_ptr(), codes.data_ptr(), bp.data_ptr(),
        out.data_ptr(), m, n, k, k4, _build.device_index(v0),
        _build.stream_ptr(v0)), "fp1_cuda")
    fp1_cuda.launches += 1
    return out


fp1_cuda.launches = 0


def fp1_plain(v0, v1, codes, b) -> torch.Tensor:
    """Plain version of ``run_probe_fp1``'s product, from b in the JAX
    probe's row order: ``sum over q, g of A[m, 4g + q] * b[q*k4 + g]``."""
    k4, m = v0.shape
    a_q = k3.expand_planes(v0, v1, codes).float().reshape(k4, 4, m)
    a_q = a_q.permute(1, 0, 2).reshape(4 * k4, m)  # row q*k4 + g
    return (a_q.T @ b.float()).to(torch.bfloat16)


# --- the probe ---------------------------------------------------------------

def operands(m: int, n: int, k: int, gen: torch.Generator):
    """K3's operands at ``m x n x k``: the planes of a pruned random bf16
    A and a random b, from ``gen`` on its device."""
    from ..ops.kernels.prune_kernel import (prune_compress_24_cuda,
                                            prune_compress_24_plain)

    dev = gen.device
    a = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
    b = torch.randn((k, n), generator=gen, device=dev).to(torch.bfloat16)
    compress = (prune_compress_24_cuda if dev.type == "cuda"
                else prune_compress_24_plain)
    v0, v1, codes = compress(a)
    return v0, v1, codes, b


def errors(got: torch.Tensor, want: torch.Tensor) -> Tuple[float, float]:
    """The largest absolute error, and it over the largest ``|want|``."""
    err = float((got.float() - want.float()).abs().max())
    return err, err / max(float(want.float().abs().max()), 1e-30)


def check(v0, v1, codes, b, what: Union[Tuple[str, int], str]
          ) -> Tuple[float, float]:
    """Hold one launch of ``what``, a ``(mode, stages)`` of
    :data:`VARIANTS` or ``"fp1"`` (b in the JAX probe's order), to its plain
    version on the same CUDA operands: the output within 2e-2 of the largest
    ``|want|``, the side words exactly. Returns :func:`errors`."""
    if what == "fp1":
        got = fp1_cuda(v0, v1, codes, fp1_operand(b))
        want = fp1_plain(v0, v1, codes, b)
    else:
        mode, st = what
        got, side = units_cuda(v0, v1, codes, b, mode=mode, stages=st)
        bm, bn = units_tile(v0, b)
        want, want_side = units_plain(v0, v1, codes, b, mode=mode,
                                      stages=st, bm=bm, bn=bn)
        if not torch.equal(side, want_side):
            raise AssertionError(f"units {what}: the side words differ from "
                                 "the plain ones")
    err = errors(got, want)
    if not err[1] <= 2e-2:
        raise AssertionError(f"units {what}: rel err {err[1]} > 2e-2")
    return err


def bounds_ms(m: int, n: int, k: int) -> Dict[str, Tuple[float, str]]:
    """Each probe's bound (ms, what bounds it) on the data sheet's H100:
    ``feed`` the bytes it must move (A's planes at 1.25 B a logical
    element, b and C once each), ``mma`` the 2:4 operations at the 2:4
    rate (and C's bytes), ``full`` K3's bound (the larger of the two)."""
    from .roofline import H100, bound_by

    byts = 1.25 * m * k + 2.0 * k * n + 2.0 * m * n
    flops = 2.0 * m * n * k
    rate = H100.sparse24_tflops

    def ms(f, b):
        return (max(f / (rate * 1e12), b / (H100.hbm_gbps * 1e9)) * 1e3,
                bound_by(f, rate, b))
    return {"feed": ms(0.0, byts), "mma": ms(flops, 2.0 * m * n),
            "full": ms(flops, byts)}


def probe_shape(m: int, n: int, k: int, gen: torch.Generator, *,
                iters: int = 20, reps: int = 5) -> dict:
    """Every variant, :func:`fp1_cuda` and K3 at one shape on the card:
    each held to its plain version (:func:`check`) and timed; returns the
    times, relative errors and ``overlap_frac`` per ring depth."""
    from ..utils.timing import time_kernel

    v0, v1, codes, b = operands(m, n, k, gen)
    bm, bn = units_tile(v0, b)
    res = {"shape": f"{m}x{n}x{k}", "tile": f"{bm}x{bn}", "ms": {},
           "err": {}}
    ops = (v0, v1, codes, b)
    for mode, st in VARIANTS:
        name = f"{mode}_s{st}"
        res["err"][name] = check(*ops, (mode, st))[1]
        res["ms"][name] = time_kernel(
            lambda *x, mode=mode, st=st: units_cuda(*x, mode=mode,
                                                    stages=st),
            ops, iters=iters, reps=reps).ms
    res["err"]["fp1"] = check(*ops, "fp1")[1]
    bq = fp1_operand(b)
    res["ms"]["fp1"] = time_kernel(fp1_cuda, (v0, v1, codes, bq),
                                   iters=iters, reps=reps).ms
    kw = dict(k_logical=k, out_dtype=torch.bfloat16)
    res["ms"]["k3"] = time_kernel(lambda *x: k3.spmm24_cuda(*x, **kw), ops,
                                  iters=iters, reps=reps).ms
    for st in (4, 2):
        feed, mma, both = (res["ms"][f"{md}_s{st}"]
                           for md in ("feed", "mma", "full"))
        res[f"overlap_frac_s{st}"] = (feed + mma - both) / min(feed, mma)
    res["bounds"] = bounds_ms(m, n, k)
    return res


def card_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True,
                          capture_output=True, text=True).stdout.strip()


def main() -> int:
    if not torch.cuda.is_available():
        print("units_probe: needs a CUDA device", file=sys.stderr)
        return 1
    card = card_line()
    print(f"card: {card}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for m, n, k in SHAPES:
        r = probe_shape(m, n, k, gen)
        ms, bd = r["ms"], r["bounds"]
        print(f"{r['shape']} tile {r['tile']}: "
              + " ".join(f"{v}={ms[v]:.4f}" for v in ms)
              + f" | overlap_frac s4={r['overlap_frac_s4']:.3f} "
              f"s2={r['overlap_frac_s2']:.3f} | bound ms feed "
              f"{bd['feed'][0]:.4f} ({bd['feed'][1]}) mma {bd['mma'][0]:.4f} "
              f"({bd['mma'][1]}) both {bd['full'][0]:.4f} ({bd['full'][1]})"
              f" | max rel err {max(r['err'].values()):.2e} | {card}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
