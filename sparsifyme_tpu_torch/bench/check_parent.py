"""Hold K2, K3 and K7 to their build from another checkout of the port.

K2 (``csrc/compress24.cu``), K3 (``csrc/spmm24.cu``) and K7
(``csrc/ring24.cu``) share their bodies with the probes of
``bench/fused_probe.py`` and ``bench/units_probe.py``:
``csrc/compress24_tile.cuh`` and ``csrc/sp24_tile.cuh`` take the probes'
modes as template parameters whose defaults are the shipped kernels. A
change to either header must leave those kernels as they were. This script
builds their three libraries from another checkout (the parent commit,
unpacked with ``git archive``) beside this tree's and checks:

* SASS: every kernel body of the other build of ``libcompress24.so``,
  ``libspmm24.so``, ``libring24.so``, of K1's, K4's, K5's and K6's
  libraries and of the ``wgmma_sp`` probe's (``libsp24_wg_units.so``,
  whose tile K3's route and K7's ``wgmma_sp`` step share)
  (``cuobjdump --dump-sass``, address comments removed) is in
  this build, compared as multisets of bodies (a template parameter added
  with a default renames a kernel, not its code); a library may gain
  kernels (K3's gained its ``wgmma_sp`` route and pack kernel), and each
  line says whether the two are identical;
* outputs, bit for bit on the same card tensors: K2 and its fused route;
  K3 at every tile in bf16 and f32 out, with the epilogue
  (``transpose_out``, alpha, beta, C), on the fold route (k <= 1024) and
  on its ``wgmma_sp`` route with its pack (M % 128, n % 64), at
  the six bench shapes, a shape of the JAX units probe and a ragged one
  (b = 32); both K7 rings at 784x256x1024 (b = 32) on four ranks of one
  card.

The other build is called through the C entries this tree loads (their
argument types included), so the other checkout must have the same C
entries.

Usage (needs one GPU and ``nvcc``)::

    mkdir -p .chip_archive/parent          # a directory .gitignore lists
    git archive <commit> | tar -x -C .chip_archive/parent
    python -m sparsifyme_tpu_torch.bench.check_parent .chip_archive/parent

Prints one line per library and per shape; exits 1 on any difference.
"""

from __future__ import annotations

import collections
import ctypes
import re
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Callable, Dict

import torch

from .. import _build
from ..utils import sass

LIBS = ("compress24", "spmm24", "ring24", "prune_nm", "ell_spmm",
        "ell_expand", "coo_spmm", "sp24_wg_units")
# m x n x k (b = 32 folded into m in the operands): the bench shapes, the
# JAX units probe's first (3136 = 100352 / 32) and a ragged one
SHAPES = [(12544, 64, 147), (12544, 64, 576), (12544, 256, 64),
          (3136, 128, 1152), (784, 256, 1024), (196, 512, 4608),
          (3136, 128, 512), (208, 72, 200)]
BATCH = 32


def sass_functions(lib: Path) -> Dict[str, str]:
    """``{mangled name: SASS}`` of a built library, each instruction line
    without its address and encoding comments."""
    funcs = {}
    for part in sass.dump(lib).split("Function : ")[1:]:
        name, _, body = part.partition("\n")
        lines = []
        for ln in body.splitlines():
            ln = re.sub(r"/\*[0-9a-f]{4,}\*/", "", ln)
            ln = re.sub(r"/\* 0x[0-9a-f]+ \*/", "", ln).strip()
            if ln:
                lines.append(ln)
        funcs[name.strip()] = "\n".join(lines)
    return funcs


def build_other(root: Path, out: Path) -> None:
    """Compile the other checkout's :data:`LIBS` into ``out``, one ``nvcc``
    each, in parallel, with this tree's flags."""
    src = root / "sparsifyme_tpu_torch" / "csrc"
    nvcc = _build.find_nvcc()

    def one(name):
        return subprocess.run(
            [nvcc, *_build.NVCC_FLAGS, "-I", str(src), "-o",
             str(out / f"lib{name}.so"), str(src / f"{name}.cu")],
            capture_output=True, text=True)
    with ThreadPoolExecutor(len(LIBS)) as pool:
        for name, p in zip(LIBS, pool.map(one, LIBS)):
            if p.returncode:
                raise _build.KernelBuildError(
                    f"nvcc failed on the other {name}.cu:\n{p.stdout}\n"
                    f"{p.stderr}")


def same_sass(other: Path) -> bool:
    ok = True
    for name in LIBS:
        a = collections.Counter(
            sass_functions(other / f"lib{name}.so").values())
        b = collections.Counter(
            sass_functions(_build.build_dir() / f"lib{name}.so").values())
        kept = not a - b
        print(f"SASS {name}: {sum(a.values())} kernels other, "
              f"{sum(b.values())} here, every other body here: {kept}, "
              f"identical: {a == b}", flush=True)
        ok &= kept
    return ok


def bitwise(fn: Callable, other: Path) -> bool:
    """``fn()`` on this tree's kernels and on the other build's (the
    entries of :data:`LIBS` that this tree loaded, rebound to the other
    libraries), each output equal bit for bit."""
    new = fn()
    saved = {key: e for key, e in _build._entries.items() if key[0] in LIBS}
    for (name, entry), e in saved.items():
        lib = ctypes.CDLL(str(other / f"lib{name}.so"))
        if not hasattr(lib, entry):
            continue  # an entry the other build does not have
        fo = getattr(lib, entry)
        fo.argtypes, fo.restype = e.argtypes, e.restype
        _build._entries[(name, entry)] = fo
    try:
        old = fn()
    finally:
        _build._entries.update(saved)
    torch.cuda.synchronize()
    if isinstance(new, torch.Tensor):
        new, old = (new,), (old,)
    return all(a.dtype == b.dtype and torch.equal(_bits(a), _bits(b))
               for a, b in zip(new, old))


def _bits(t: torch.Tensor) -> torch.Tensor:
    """``t``'s bits as integers of its width (a -0.0 is not a 0.0)."""
    if t.is_floating_point():
        return t.view({2: torch.int16, 4: torch.int32}[t.element_size()])
    return t


def same_outputs(other: Path) -> bool:
    from .. import make_mesh, spmm_24_ring_explicit, spmm_24_ring_tiled
    from ..ops.kernels import prune_kernel as pk
    from ..ops.kernels import spmm24_kernel as k3
    from ..ops.sparse24 import prune_compress_24
    from ..parallel import ring_graph

    gen = torch.Generator(device="cuda").manual_seed(0)
    ok = True
    for m, n, k in SHAPES:
        a = torch.randn((BATCH * m, k), generator=gen, device="cuda").to(
            torch.bfloat16)
        b = torch.randn((k, n), generator=gen, device="cuda").to(
            torch.bfloat16)
        r = [bitwise(lambda: pk.compress_24_cuda(a), other),
             bitwise(lambda: pk.prune_compress_24_cuda(a), other)]
        v0, v1, codes = pk.compress_24_cuda(pk.prune_nm_cuda(a)[0])
        for tile in range(len(k3.SP_TILES)):
            for odt in (torch.bfloat16, torch.float32):
                r.append(bitwise(lambda: k3.spmm24_cuda(
                    v0, v1, codes, b, k_logical=k, out_dtype=odt,
                    tile=tile), other))
        c = torch.ones((BATCH * m, n), device="cuda")
        r.append(bitwise(lambda: k3.spmm24_cuda(
            v0, v1, codes, b, k_logical=k, out_dtype=torch.bfloat16,
            transpose_out=True, alpha=0.5, beta=2.0, c=c), other))
        if (BATCH * m) % k3.WG_BM == 0 and n % 64 == 0:
            r.append(bitwise(lambda: k3.pack_wgmma_sp_cuda(v0, v1, codes),
                             other))
            wg = k3.pack_wgmma_sp_cuda(v0, v1, codes)
            r.append(bitwise(lambda: k3.spmm24_wg_cuda(
                wg, b, m=BATCH * m, k_logical=k,
                out_dtype=torch.bfloat16), other))
        if k <= 1024:
            s2 = prune_compress_24(a, fold=2)
            r.append(bitwise(lambda: k3.spmm24_fold_cuda(
                s2.values0, s2.values1, s2.codes, b, k_logical=k,
                out_dtype=torch.bfloat16), other))
        print(f"bitwise K2/fused/K3 {m}x{n}x{k}: {r}", flush=True)
        ok &= all(r)
    mesh = make_mesh((4,), ("model",), devices=["cuda:0"] * 4)
    a = torch.randn((BATCH, 784, 1024), generator=gen, device="cuda").to(
        torch.bfloat16)
    b = torch.randn((1024, 256), generator=gen, device="cuda").to(
        torch.bfloat16)
    s = prune_compress_24(a)
    for ring in (spmm_24_ring_explicit, spmm_24_ring_tiled):
        def run(ring=ring):
            ring_graph.clear()  # a captured ring would replay old launches
            return ring(s, b, mesh, "model")
        r = bitwise(run, other)
        print(f"bitwise K7 {ring.__name__}: {r}", flush=True)
        ok &= r
    return ok


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1 or not torch.cuda.is_available():
        print("usage: python -m sparsifyme_tpu_torch.bench.check_parent "
              "<root of the other checkout>   (needs one GPU)",
              file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"card: {card}", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        other = Path(tmp)
        with ThreadPoolExecutor(1) as pool:
            fut = pool.submit(build_other, Path(argv[0]), other)
            _build.build_all()
            fut.result()
        ok = same_sass(other)
        ok &= same_outputs(other)
    print("same as the other build" if ok else "DIFFERS from the other build",
          flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
