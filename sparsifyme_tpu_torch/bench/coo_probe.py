"""K6 (``csrc/coo_spmm.cu``) under every plan, and K2 (``csrc/compress24.cu``)
and K1 (``csrc/prune_nm.cu``) at the bench shapes, on the device.

* ``--plans`` times K6 at BASELINE config 2 points (b=32, bf16 B) under
  each plan :func:`~sparsifyme_tpu_torch.ops.kernels.coo_kernel.coo_plan`
  can choose (route ``staged`` or ``gather``, 1 to 8 splits), forced in
  place of the picked one through ``coo_kernel.card_plan``, each product
  held to the plain version; at 0.99 and above on both routes' layouts
  (:func:`layout_kcs`).
* ``--routes`` times each route on its own layout (:func:`route_plans`)
  at ten config 2 shapes from 0.95 to 0.995 sparsity, with the entries a
  staged B row feeds: where the routes cross sets ``STAGE_MIN_REUSE``.
* ``--shapes`` (the default) times K6 through its wrapper at the same
  points beside ``torch.sparse.mm`` (f32) and its bound, with the layout
  built outside the timed calls where the tree has one (and its build time
  printed); it runs against any tree of the port, so that one chip call can
  time two trees in turns (``PYTHONPATH=<tree> python <this file>
  --shapes``).
* ``--compress`` times K2 and its fused route at the six bench shapes
  (b=32, bf16) against ``compress_sol_ms``, each result exactly equal to
  the plain version; it also runs against any tree.
* ``--prune`` times K1 at the 17 unique ResNet-50 shapes (b=32, bf16)
  against ``prune_sol_ms``, each result exactly equal to the plain
  version: ``ms`` per call as a caller sees it (CUDA events; where a call
  is shorter than the host's time to queue it, that time) and
  ``kernel_ms``, K1's device time (``torch.profiler``); it also runs
  against any tree.
* ``--prune-tiles`` times K1's tile kernel at 12544x64x147 under tiles
  of 8, 16, 24 and 32 KB of input (``prune_kernel.prune_plan``'s
  ``tile_bytes``, forced in place of the plan's own).
* ``--ablate`` rebuilds K6, K2 and K1 with parts of their work taken out
  (:data:`ABLATIONS`: K6 without its entry loop, or with its B reads
  replaced by a constant; K2 without its ranking, or without ranking and
  stores; K1 keeping every member without ranking it, or with loads and
  stores only: the tiles unranked, the stream route storing what it
  loaded) and gives each build's device time (``torch.profiler``)
  at the kernels-line points (K1 at 12544x64x147, 3136x128x1152 and
  12544x256x64): what is left when a part goes is what that part costs.
  The results of an ablated build are wrong by design.

A measurement script: the port does not import it.

Usage: PYTHONPATH=. python sparsifyme_tpu_torch/bench/coo_probe.py
       [--plans | --routes | --shapes | --compress | --prune |
        --prune-tiles | --ablate]
       (needs one GPU)
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from sparsifyme_tpu_torch.ops.kernels import coo_kernel as ck
from sparsifyme_tpu_torch.ops.kernels import prune_kernel as pk
from sparsifyme_tpu_torch.utils.timing import time_kernel

BATCH = 32
# m, n, k, sparsity: the kernels line's three points, then config 2's
# sparsities at its named shape and the other shapes' worst cases
POINTS = [(3136, 128, 1152, 0.9), (196, 512, 4608, 0.5),
          (3136, 128, 1152, 0.995), (3136, 128, 1152, 0.5),
          (3136, 128, 1152, 0.7), (3136, 128, 1152, 0.95),
          (3136, 128, 1152, 0.99), (12544, 64, 576, 0.5),
          (196, 512, 4608, 0.995), (784, 1024, 256, 0.9)]
# --routes: config 2 shapes and sparsities around the route threshold,
# deep k first, then k <= 256 (at most two staged chunks)
ROUTE_SHAPES = [(3136, 128, 1152), (196, 512, 4608), (12544, 64, 576),
                (196, 2048, 512), (784, 256, 2304), (784, 1024, 256),
                (12544, 64, 147), (12544, 256, 64), (3136, 512, 128),
                (12544, 128, 256)]
ROUTE_SPARSITIES = (0.95, 0.97, 0.98, 0.99, 0.995)
COMPRESS_SHAPES = [(12544, 64, 147), (12544, 64, 576), (12544, 256, 64),
                   (3136, 128, 1152), (784, 256, 1024), (196, 512, 4608)]
# K1's --ablate shapes: its worst (odd k: whole-row tiles), the named
# shape and the shallow one (the stream route); --prune-tiles times the
# first
PRUNE_SHAPES = [(12544, 64, 147), (3136, 128, 1152), (12544, 256, 64)]
PRUNE_TILE_BYTES = (8192, 16384, 24576, 32768)
ROUTES = ("staged", "gather")
# source edits of --ablate: (source, C entry point, its ctypes spec,
# {build name: [(text, replacement), ...]})
ABLATIONS = {
    "coo_spmm": ("coo_spmm_launch", "pppppp" "iiiiiiiiiiiiii" "p", {
        "no entry loop": [(
            "if (live) {  // the stream's rows' segments within [w0, w1)",
            "if (false) {")],
        "no B reads": [(
            "load8(bs + (col - c * p.kc) * kTileN + lane * 8, v);",
            "for (int q = 0; q < 8; ++q) v[q] = (float)col;")],
    }),
    "compress24": ("compress24_launch", "pppp" "iiiiiii" "p", {
        "no ranking": [(
            "      rank_tile<T, MODE>(g, tile, s0, s1, sc, M, k, r0, c0);\n",
            "")],
        "loads only": [
            ("      rank_tile<T, MODE>(g, tile, s0, s1, sc, M, k, r0, c0);\n",
             ""),
            ("      store_tile(g, s0, s1, sc, v0, v1, codes, M, r0, c0, "
             "vec_out);\n", "")],
    }),
    "prune_nm": ("prune_nm_launch", "ppp" "l" "iiiiiiii" "p", {
        "no ranking": [("    keep[j] = beaten < n;",
                        "    keep[j] = true;")],
        "loads and stores only": [
            ("    rank_tile<T, MM>(t, buf, mk, n, m);\n", ""),
            ("reinterpret_cast<uint4*>(out)[c] = pack(o);",
             "reinterpret_cast<uint4*>(out)[c] = pack(x);"),
            ("reinterpret_cast<uint4*>(mask)[c] = pack(mk);",
             "reinterpret_cast<uint4*>(mask)[c] = pack(x);")],
    }),
}
# the file whose text a source's ablations edit, where it is not the source
# itself: K2's body is compress24_tile.cuh (the .cu includes it)
ABLATED_FILES = {"compress24": "compress24_tile.cuh"}


def ablated_file(src: str) -> str:
    return ABLATED_FILES.get(src, f"{src}.cu")


def layout_kcs(kc, sp):
    """The k-chunks ``--plans`` times at a point: the layout's own ``kc``;
    where the two routes are close (sparsity 0.99 and above), also the
    other route's layout: a staged chunk of ``KC_CHOICES[0]`` rows beside
    the gather route's ``GATHER_KC``, so that ``STAGE_MIN_REUSE`` rests on
    both routes timed on both layouts."""
    if sp < 0.99:
        return [kc]
    return [kc, ck.KC_CHOICES[0] if kc == ck.GATHER_KC else ck.GATHER_KC]


def route_plans(mb, k, nnz, cols, peak=None):
    """``(kc, plan)`` of each route on its own layout, splits as the plan
    picks them: staged on chunks of ``KC_CHOICES[0]`` rows (``coo_kc``'s
    choice at 0.95 and sparser), gather on ``GATHER_KC``."""
    return [(kc, ck.coo_plan(mb, 128, k, kc, nnz, cols, routes=(route,),
                             peak=peak))
            for route, kc in (("staged", ck.KC_CHOICES[0]),
                              ("gather", ck.GATHER_KC))]


def plans(mb, bm, k, kc, nnz, cols, peak=None):
    """Every plan ``coo_plan`` can return for one launch: each route, each
    split count that leaves no split empty."""
    out = []
    for route in ROUTES:
        for s in range(1, ck.MAX_SPLITS + 1):
            plan = ck.coo_plan(mb, bm, k, kc, nnz, cols, routes=(route,),
                               split_counts=(s,), peak=peak)
            if plan is not None and plan not in out:
                out.append(plan)
    return out


def _operand(m, k, sp, gen):
    """A ``[m, k]`` f32 matrix threshold-pruned to ``sp`` as a Coo on the
    card, and its packed planes."""
    from sparsifyme_tpu_torch.ops.coo import coo_from_dense, pack_coo
    from sparsifyme_tpu_torch.ops.prune import prune_threshold

    a = torch.randn((m, k), generator=gen, device="cuda")
    thr = float(torch.quantile(a.abs().flatten(), sp))
    coo = coo_from_dense(prune_threshold(a, thr)[0])
    return coo, pack_coo(coo)


def _rel(out, ref):
    return float((out - ref).abs().max() / ref.abs().max())


def _ms(fn, ops):
    return time_kernel(fn, ops, iters=10, reps=3).ms


def run_plans() -> int:
    gen = torch.Generator(device="cuda").manual_seed(0)
    saved = ck.card_plan
    try:
        for m, n, k, sp in POINTS:
            coo, packed = _operand(m, k, sp, gen)
            b = torch.randn((BATCH, k, n), generator=gen,
                            device="cuda").to(torch.bfloat16)
            want = ck.spmm_coo_plain(*packed, b, m=m)
            mb = packed[0].shape[0]
            for kc in layout_kcs(ck.coo_layout(*packed, k=k).kc, sp):
                lay = ck.coo_layout(*packed, k=k, kc=kc)
                pick = saved(b.device, mb, 128, k, lay.kc, lay.nnz,
                             BATCH * n, lay.peak)
                line = (f"{m}x{n}x{k}x{BATCH} sp={sp} kc={lay.kc} picked "
                        f"{pick.route if pick else None}/"
                        f"{pick.splits if pick else None}:")
                for plan in plans(mb, 128, k, lay.kc, lay.nnz, BATCH * n,
                                  lay.peak):
                    ck.card_plan = lambda *a, p=plan: p
                    # A is the format: only B is replicated by the timer
                    fn = lambda y, lay=lay: ck.spmm_coo_cuda(  # noqa: E731
                        *packed, y, m=m, layout=lay)
                    err = _rel(fn(b), want)
                    ms = _ms(fn, (b,))
                    line += f" {plan.route}/{plan.splits} {ms:.4f}"
                    if not err < 1e-4:
                        line += f" (BAD rel err {err:.1e})"
                    ck.card_plan = saved
                print(line, flush=True)
            del coo, packed, lay, b, want
            torch.cuda.empty_cache()
    finally:
        ck.card_plan = saved
    return 0


def run_routes() -> int:
    gen = torch.Generator(device="cuda").manual_seed(0)
    saved = ck.card_plan
    try:
        for m, n, k in ROUTE_SHAPES:
            for sp in ROUTE_SPARSITIES:
                coo, packed = _operand(m, k, sp, gen)
                b = torch.randn((BATCH, k, n), generator=gen,
                                device="cuda").to(torch.bfloat16)
                want = ck.spmm_coo_plain(*packed, b, m=m)
                mb = packed[0].shape[0]
                lay = ck.coo_layout(*packed, k=k)
                # entries of a row group a staged B row feeds, as coo_plan
                # reckons them against STAGE_MIN_REUSE
                reuse = lay.nnz / (mb * k)
                line = (f"{m}x{n}x{k}x{BATCH} sp={sp} reuse={reuse:.3f} "
                        f"picked {lay.kc}:")
                for kc, plan in route_plans(mb, k, lay.nnz, BATCH * n,
                                            lay.peak):
                    lay = ck.coo_layout(*packed, k=k, kc=kc)
                    ck.card_plan = lambda *a, p=plan: p
                    fn = lambda y, lay=lay: ck.spmm_coo_cuda(  # noqa: E731
                        *packed, y, m=m, layout=lay)
                    err = _rel(fn(b), want)
                    line += (f" {plan.route}/kc={kc}/{plan.splits} "
                             f"{_ms(fn, (b,)):.4f}")
                    if not err < 1e-4:
                        line += f" (BAD rel err {err:.1e})"
                    ck.card_plan = saved
                print(line, flush=True)
                del coo, packed, lay, b, want
                torch.cuda.empty_cache()
    finally:
        ck.card_plan = saved
    return 0


def run_shapes() -> int:
    from sparsifyme_tpu_torch.bench import roofline as rl

    has_layout = hasattr(ck, "coo_layout")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for m, n, k, sp in POINTS:
        coo, packed = _operand(m, k, sp, gen)
        b = torch.randn((BATCH, k, n), generator=gen,
                        device="cuda").to(torch.bfloat16)
        kw = {}
        layout_ms = float("nan")
        if has_layout:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            kw["layout"] = ck.coo_layout(*packed, k=k)
            torch.cuda.synchronize()
            layout_ms = (time.perf_counter() - t0) * 1e3
        # A is the format: only B is replicated by the timer
        fn = lambda y: ck.spmm_coo_cuda(*packed, y, m=m, **kw)  # noqa: E731
        err = _rel(fn(b), ck.spmm_coo_plain(*packed, b, m=m))
        a_sp = torch.sparse_coo_tensor(
            torch.stack([coo.rows.long(), coo.cols.long()]), coo.values,
            (m, k)).coalesce()
        b_fold = b.float().permute(1, 0, 2).reshape(k, BATCH * n)
        flops, byts = rl.coo_spmm_work(coo.nnz, packed[0].numel(), m, k, n,
                                       BATCH)
        bound = max(flops / (rl.H100.f32_tflops * 1e12),
                    byts / (rl.H100.hbm_gbps * 1e9)) * 1e3
        ms = _ms(fn, (b,))
        print(f"K6 {m}x{n}x{k}x{BATCH} sp={sp} ms={ms:.4f} "
              f"sparse_mm_ms={_ms(torch.sparse.mm, (a_sp, b_fold)):.4f} "
              f"bound_ms={bound:.4f} layout_ms={layout_ms:.4f} "
              f"rel_err={err:.1e}", flush=True)
        del coo, packed, b, a_sp, b_fold, kw
        torch.cuda.empty_cache()
    return 0


def run_compress() -> int:
    from sparsifyme_tpu_torch.bench.roofline import compress_sol_ms

    gen = torch.Generator(device="cuda").manual_seed(0)
    for m, n, k in COMPRESS_SHAPES:
        a = torch.randn((BATCH * m, k), generator=gen,
                        device="cuda").to(torch.bfloat16)
        pw = pk.prune_nm_cuda(a)[0]
        bound = compress_sol_ms(m, k, BATCH)
        line = f"K2 {m}x{n}x{k}x{BATCH} bound_ms={bound:.4f}"
        for name, fn, w, plain in (
                ("compress", pk.compress_24_cuda, pw, pk.compress_24_plain),
                ("fused", pk.prune_compress_24_cuda, a,
                 pk.prune_compress_24_plain)):
            same = all(torch.equal(x, y) for x, y in zip(fn(w), plain(w)))
            ms = time_kernel(fn, (w,), iters=20, reps=3).ms
            line += (f" {name}_ms={ms:.4f} frac={bound / ms:.3f}"
                     f"{'' if same else ' (NOT EQUAL)'}")
        print(line, flush=True)
        del a, pw
        torch.cuda.empty_cache()
    return 0


def _prune_shapes():
    from sparsifyme_tpu_torch.models.resnet_shapes import resnet_conv_shapes

    return list(dict.fromkeys((s.m, s.n, s.k)
                              for s in resnet_conv_shapes("resnet50")))


def _prune_line(m, n, k, gen, tag=""):
    """K1 at ``[BATCH * m, k]`` bf16: its time against its bound, the
    result held to the plain version (bit for bit where the tree defines
    ``same_bits``, else by value)."""
    from sparsifyme_tpu_torch.bench.roofline import prune_sol_ms

    same = getattr(pk, "same_bits", torch.equal)
    a = torch.randn((BATCH * m, k), generator=gen,
                    device="cuda").to(torch.bfloat16)
    ok = all(same(x, y) for x, y in zip(pk.prune_nm_cuda(a),
                                         pk.prune_nm_plain(a)))
    bound = prune_sol_ms(m, k, BATCH)
    ms = time_kernel(pk.prune_nm_cuda, (a,), iters=50, reps=5).ms
    kernel_ms = _device_ms(pk.prune_nm_cuda, (a,))
    print(f"K1 {m}x{n}x{k}x{BATCH}{tag} bound_ms={bound:.4f} ms={ms:.4f} "
          f"frac={bound / ms:.3f} kernel_ms={kernel_ms:.4f}"
          f"{'' if ok else ' (NOT EQUAL)'}", flush=True)
    del a
    torch.cuda.empty_cache()
    return ok


def run_prune() -> int:
    gen = torch.Generator(device="cuda").manual_seed(0)
    bad = [s for s in _prune_shapes() if not _prune_line(*s, gen)]
    return 1 if bad else 0


def run_prune_tiles() -> int:
    gen = torch.Generator(device="cuda").manual_seed(0)
    saved = pk.prune_plan
    ok = True
    try:
        for tb in PRUNE_TILE_BYTES:
            pk.prune_plan = lambda *a, tb=tb: saved(*a, tile_bytes=tb)
            ok &= _prune_line(*PRUNE_SHAPES[0], gen, f" tile_bytes={tb}")
    finally:
        pk.prune_plan = saved
    return 0 if ok else 1


def _device_ms(fn, ops, calls=10):
    """Device time per call: every kernel ``fn`` launches, summed by
    ``torch.profiler``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn(*ops)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn(*ops)
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e3 / calls


def _ablated(src, entry, spec, edits, out, nvcc, name=None):
    """``src`` rebuilt with ``edits`` to file ``name`` (by default
    :func:`ablated_file`'s) into ``out``: its C entry point. The edited file
    goes into ``out``'s directory, beside a copy of the source where the
    edits are in a header it includes (found there first)."""
    from sparsifyme_tpu_torch import _build

    name = name or ablated_file(src)
    text = (_build.CSRC / name).read_text()
    for old, new in edits:
        if old not in text:
            raise RuntimeError(f"{name} no longer holds {old!r}")
        text = text.replace(old, new)
    out.parent.mkdir(parents=True, exist_ok=True)
    (out.parent / name).write_text(text)
    cu = out.parent / f"{src}.cu"
    if name != cu.name:
        cu.write_text((_build.CSRC / cu.name).read_text())
    subprocess.run([nvcc, *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
                    str(out), str(cu)], check=True, capture_output=True)
    fn = getattr(ctypes.CDLL(str(out)), entry)
    fn.argtypes = _build.argtypes(spec)
    fn.restype = ctypes.c_int
    return fn


def run_ablate() -> int:
    from sparsifyme_tpu_torch import _build

    nvcc = _build.find_nvcc()
    _build.build_all()
    jobs = [(src, name, entry, spec, edits)
            for src, (entry, spec, builds) in ABLATIONS.items()
            for name, edits in builds.items()]
    with tempfile.TemporaryDirectory() as tmp, ThreadPoolExecutor(
            len(jobs)) as pool:
        futs = [pool.submit(_ablated, src, entry, spec, edits,
                            Path(tmp) / str(i) / f"lib{src}.so", nvcc)
                for i, (src, _, entry, spec, edits) in enumerate(jobs)]
        builds = {}
        for (src, name, *_), f in zip(jobs, futs):
            builds.setdefault(src, {})[name] = f.result()
    gen = torch.Generator(device="cuda").manual_seed(0)
    try:
        for m, n, k, sp in POINTS[:3]:
            _, packed = _operand(m, k, sp, gen)
            lay = ck.coo_layout(*packed, k=k)
            b = torch.randn((BATCH, k, n), generator=gen,
                            device="cuda").to(torch.bfloat16)
            fn = lambda y: ck.spmm_coo_cuda(*packed, y, m=m,  # noqa: E731
                                            layout=lay)
            line = (f"K6 {m}x{n}x{k}x{BATCH} sp={sp} device ms: whole "
                    f"{_device_ms(fn, (b,)):.4f}")
            for name, entry in builds["coo_spmm"].items():
                _build._entries[("coo_spmm", "coo_spmm_launch")] = entry
                line += f", {name} {_device_ms(fn, (b,)):.4f}"
            _build._entries.pop(("coo_spmm", "coo_spmm_launch"))
            print(line, flush=True)
        for m, n, k in COMPRESS_SHAPES:
            w = torch.randn((BATCH * m, k), generator=gen,
                            device="cuda").to(torch.bfloat16)
            line = (f"K2 {m}x{n}x{k}x{BATCH} device ms: whole "
                    f"{_device_ms(pk.compress_24_cuda, (w,)):.4f}")
            for name, entry in builds["compress24"].items():
                _build._entries[("compress24", "compress24_launch")] = entry
                line += (f", {name} "
                         f"{_device_ms(pk.compress_24_cuda, (w,)):.4f}")
            _build._entries.pop(("compress24", "compress24_launch"))
            print(line, flush=True)
        for m, n, k in PRUNE_SHAPES:
            w = torch.randn((BATCH * m, k), generator=gen,
                            device="cuda").to(torch.bfloat16)
            line = (f"K1 {m}x{n}x{k}x{BATCH} device ms: whole "
                    f"{_device_ms(pk.prune_nm_cuda, (w,)):.4f}")
            for name, entry in builds["prune_nm"].items():
                _build._entries[("prune_nm", "prune_nm_launch")] = entry
                line += f", {name} {_device_ms(pk.prune_nm_cuda, (w,)):.4f}"
            _build._entries.pop(("prune_nm", "prune_nm_launch"))
            print(line, flush=True)
    finally:
        for src, (entry, *_) in ABLATIONS.items():
            _build._entries.pop((src, entry), None)
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("coo_probe: needs a CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True,
                          capture_output=True, text=True).stdout.strip()
    print(f"card: {card}", flush=True)
    args = sys.argv[1:]
    if "--plans" in args:
        return run_plans()
    if "--routes" in args:
        return run_routes()
    if "--compress" in args:
        return run_compress()
    if "--prune" in args:
        return run_prune()
    if "--prune-tiles" in args:
        return run_prune_tiles()
    if "--ablate" in args:
        return run_ablate()
    return run_shapes()


if __name__ == "__main__":
    sys.exit(main())
