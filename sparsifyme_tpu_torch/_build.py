"""Builder and loader of the port's CUDA kernels.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, and loaded with ``ctypes``
(pointers and the CUDA stream passed as ``c_void_p``). No source includes
PyTorch's headers, so a build takes seconds, not minutes.

Libraries are built at first use into ``_build/<hash>/``, keyed by a hash
of the sources and flags, one ``nvcc`` process per source, all started
together. A missing ``nvcc`` or a failed build raises
:class:`KernelBuildError`: there is no fallback to a plain version.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch

from .utils import trace

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent / "_build"
SOURCES = ("prune_nm", "compress24", "spmm24", "ell_spmm", "ell_expand",
           "coo_spmm", "ring24", "ring24_wg", "sp24_units",
           "sp24_wg_units", "compress_units", "moe_combine", "rms_norm")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
DEFAULT_NVCC = "/usr/local/cuda/bin/nvcc"

_lock = threading.Lock()
_entries: Dict[Tuple[str, str], "ctypes._CFuncPtr"] = {}


class KernelBuildError(RuntimeError):
    """The CUDA kernels could not be built or loaded."""


def use_kernel(t: torch.Tensor) -> bool:
    """Dispatch rule of every kernel wrapper: True for a CUDA tensor (the
    Hopper kernel runs), False for a CPU tensor (the plain version runs,
    because the caller put the data on the CPU); any other device
    raises."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {t.device}; use cuda or cpu")


def needs_grad(*tensors) -> bool:
    """True where autograd would record a call on ``tensors``: grad mode is
    on and one of them requires grad."""
    return torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for t in tensors)


def refuse_grad(what: str, *tensors) -> None:
    """A CUDA route with no backward raises where autograd would record it,
    rather than return a result that carries no graph."""
    if needs_grad(*tensors):
        raise RuntimeError(
            f"{what} has no backward on the card (the JAX package gives it "
            "no VJP either): call it under torch.no_grad(), or with inputs "
            "that do not require grad")


def resolve_device(device=None) -> torch.device:
    """Entry points that create tensors: ``None`` means the GPU. With no
    GPU this raises instead of moving to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU")
    return dev


def find_nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``PATH``, then
    ``/usr/local/cuda/bin``."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    which = shutil.which("nvcc")
    if which:
        cands.append(which)
    cands.append(DEFAULT_NVCC)
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise KernelBuildError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and "
        "/usr/local/cuda/bin); the CUDA kernels cannot be built, and the "
        "port does not fall back to the plain versions for CUDA tensors")


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build_dir() -> Path:
    return BUILD_ROOT / source_hash()


def _compile(nvcc: str, name: str, out: Path) -> None:
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise KernelBuildError(
            f"nvcc failed on {name}.cu (exit {proc.returncode}):\n"
            f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)


def build_all() -> None:
    """Compile every source not yet built for the current hash, one
    ``nvcc`` process each, in parallel."""
    out_dir = build_dir()
    todo = [n for n in SOURCES if not (out_dir / f"lib{n}.so").exists()]
    if not todo:
        return
    with trace.trace_range("sparsifyme.kernel_build"):
        nvcc = find_nvcc()
        out_dir.mkdir(parents=True, exist_ok=True)
        with ThreadPoolExecutor(max_workers=len(todo)) as pool:
            futs = [pool.submit(_compile, nvcc, n, out_dir / f"lib{n}.so")
                    for n in todo]
            for f in futs:
                f.result()


def load(name: str, entry: str, spec: str):
    """The C entry point ``entry`` of ``lib<name>.so`` with its argument
    types set from ``spec`` (see :func:`argtypes`), building all sources
    first if needed."""
    with _lock:
        fn = _entries.get((name, entry))
        if fn is None:
            with trace.trace_range("sparsifyme.kernel_load"):
                build_all()
                path = build_dir() / f"lib{name}.so"
                try:
                    fn = getattr(ctypes.CDLL(str(path)), entry)
                except OSError as e:
                    raise KernelBuildError(
                        f"cannot load {path}: {e}") from e
                fn.argtypes = argtypes(spec)
                fn.restype = ctypes.c_int
                _entries[(name, entry)] = fn
        return fn


def raw_stream(index: int) -> int:
    """The current stream of card ``index`` as a pointer, without making a
    ``torch.cuda.Stream`` (a lean wrapper's per-call host cost)."""
    return torch._C._cuda_getCurrentRawStream(index)


class Entry:
    """The C entry point ``name`` of ``lib<lib>.so`` and its ctypes
    ``spec`` (:func:`argtypes`), declared once; every entry ends in ``int
    device, void* stream`` and launches on that card. ``entry(index,
    *args)`` calls it with ``(*args, index, raw_stream(index))`` and raises
    naming it on a nonzero ``cudaError_t``. It reads :data:`_entries`
    without the lock and calls :func:`load` on a miss, so nothing is built
    or loaded before the first call."""

    __slots__ = ("lib", "name", "spec", "key")

    def __init__(self, lib: str, name: str, spec: str):
        self.lib, self.name, self.spec = lib, name, spec
        self.key = (lib, name)

    def __call__(self, index: int, *args) -> None:
        fn = _entries.get(self.key)
        if fn is None:
            fn = load(self.lib, self.name, self.spec)
        status = fn(*args, index, raw_stream(index))
        if status != 0:
            raise RuntimeError(
                f"{self.name}: CUDA launch failed with cudaError {status}")


def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def argtypes(spec: str) -> List:
    """ctypes argument types from a compact spec, one letter each: ``p``
    pointer or stream, ``i`` int, ``l`` int64, ``f`` float."""
    table = {"p": ctypes.c_void_p, "i": ctypes.c_int,
             "l": ctypes.c_longlong, "f": ctypes.c_float}
    return [table[k] for k in spec]
