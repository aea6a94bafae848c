"""How a traffic mix drives the program: its set-up, one pass, the dense
baseline and the reference for what the pass produced.

A traffic file names its route (``"route"``): one of :data:`ROUTES`, or a
model's ``ROUTE`` in ``perfbench/model_routes/<route>.py`` (:func:`resolve`).
Each route calls the program only through its public entries, and knows
from the configuration alone what to make (a GEMM configuration's layers,
or a model configuration's keys in ``ctx.config``); the reference it hands
back is worked out from the benchmark's own inputs (``data``), never from
what the program made.
"""

from __future__ import annotations

import contextlib
import importlib.util
import sys
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import torch
from torch.profiler import record_function

from sparsifyme_tpu_torch.ops import ell as ell_ops
from sparsifyme_tpu_torch.ops import gemm, prune, sparse24
from sparsifyme_tpu_torch.parallel import ring_kernel

from . import data, reference, roofline

BF16 = torch.bfloat16
Layer = Tuple[int, int, int]  # rows on this card (batch folded), n, k


def span(traced: bool, name: str):
    return (record_function("perfbench." + name) if traced
            else contextlib.nullcontext())


class Route:
    """One traffic's path through the program. ``ctx`` carries the device,
    seed, rank, mesh and the traffic's parameters."""

    dense_baseline = True

    def setup(self, ctx, layers: Sequence[Layer]) -> list:
        raise NotImplementedError

    def outputs(self, ctx, layers: Sequence[Layer]) -> int:
        """How many outputs a pass returns, each judged against
        :meth:`reference` of its index: one a layer."""
        return len(layers)

    def run_pass(self, state: list, traced: bool) -> List[torch.Tensor]:
        raise NotImplementedError

    def reference(self, ctx, layers: Sequence[Layer], i: int,
                  control: bool) -> Tuple[torch.Tensor, Optional[
                      torch.Tensor]]:
        """Output ``i``'s float32 reference and, with ``control``, the
        control's output."""
        a, b = self.kept_inputs(ctx, layers, i)
        ref = reference.product(a, b)
        return ref, (reference.control_product(a, b) if control else None)

    def kept_inputs(self, ctx, layers, i):
        rows, n, k = layers[i]
        a = data.dense_a(rows, k, ctx.seed, i, ctx.rank, ctx.device)
        return (reference.keep_24(a),
                data.weight_b(k, n, ctx.seed, i, ctx.device))

    def dense_inputs(self, ctx, layers, state) -> list:
        return [(data.dense_a(rows, k, ctx.seed, i, ctx.rank, ctx.device),
                 data.weight_b(k, n, ctx.seed, i, ctx.device))
                for i, (rows, n, k) in enumerate(layers)]

    @staticmethod
    def dense_pass(pairs) -> List[torch.Tensor]:
        return [gemm.batched_gemm(a, b, out_dtype=BF16) for a, b in pairs]

    def designs(self, state) -> List[str]:
        return []


class Static24(Route):
    """A pruned, compressed and packed once in set-up; the window runs
    ``spmm_24`` on each layer."""

    def setup(self, ctx, layers):
        state = []
        for i, (rows, n, k) in enumerate(layers):
            a = data.dense_a(rows, k, ctx.seed, i, ctx.rank, ctx.device)
            s = sparse24.pack_wg(sparse24.compress_24(prune.prune_nm(a)[0]))
            state.append((s, data.weight_b(k, n, ctx.seed, i, ctx.device)))
        return state

    def run_pass(self, state, traced):
        out = []
        for s, b in state:
            with span(traced, "spmm24"):
                out.append(sparse24.spmm_24(s, b, out_dtype=BF16))
        return out

    def designs(self, state):
        return [sparse24.spmm24_design(s, b, out_dtype=BF16)
                for s, b in state]


class Pipeline24(Route):
    """Every pass takes each layer's dense A through the fused prune and
    compress, the pack and ``spmm_24``."""

    def setup(self, ctx, layers):
        return self.dense_inputs(ctx, layers, None)

    def run_pass(self, state, traced):
        out = []
        for a, b in state:
            with span(traced, "prune_compress24"):
                s = sparse24.prune_compress_24(a)
            with span(traced, "pack_wg"):
                s = sparse24.pack_wg(s)
            with span(traced, "spmm24"):
                out.append(sparse24.spmm_24(s, b, out_dtype=BF16))
        return out

    def dense_inputs(self, ctx, layers, state):
        if state is not None:  # the pass's own dense inputs
            return state
        return super().dense_inputs(ctx, layers, None)


class Ell(Route):
    """A made Blocked-ELL once in set-up (``ell_from_dense``); the window
    runs ``spmm_ell`` on each layer."""

    def _a(self, ctx, layers, i):
        rows, n, k = layers[i]
        bs, bk, kp, kept = roofline.ell_geometry(ctx.traffic["ell"], k)
        return data.block_scaled_a(rows, k, kp, bs, bk, kept,
                                   ctx.traffic["ell"]["small_block_scale"],
                                   ctx.seed, i, ctx.rank, ctx.device)

    def _b(self, ctx, layers, i):
        rows, n, k = layers[i]
        kp = roofline.ell_geometry(ctx.traffic["ell"], k)[2]
        b = data.weight_b(k, n, ctx.seed, i, ctx.device)
        return torch.nn.functional.pad(b, (0, 0, 0, kp - k))

    def setup(self, ctx, layers):
        state = []
        for i, (rows, n, k) in enumerate(layers):
            bs, bk, kp, kept = roofline.ell_geometry(ctx.traffic["ell"], k)
            e = ell_ops.ell_from_dense(self._a(ctx, layers, i), bs, kept, bk)
            state.append((e, self._b(ctx, layers, i)))
        return state

    def run_pass(self, state, traced):
        out = []
        for e, b in state:
            with span(traced, "ell"):
                out.append(ell_ops.spmm_ell(e, b, out_dtype=BF16))
        return out

    def kept_inputs(self, ctx, layers, i):
        rows, n, k = layers[i]
        bs, bk, kp, kept = roofline.ell_geometry(ctx.traffic["ell"], k)
        a, margin = reference.ell_keep(self._a(ctx, layers, i), bs, bk, kept)
        ctx.ell_margin = (margin if ctx.ell_margin is None
                          else min(ctx.ell_margin, margin))
        return a, self._b(ctx, layers, i)

    def dense_inputs(self, ctx, layers, state):
        return [(self._a(ctx, layers, i)[:, :k].contiguous(),
                 data.weight_b(k, n, ctx.seed, i, ctx.device))
                for i, (rows, n, k) in enumerate(layers)]


class Ring24(Route):
    """One rank of a process mesh: this rank's rows of A pruned,
    compressed and packed in set-up, B zero-padded to the planes' k and
    k-sharded; the window runs ``spmm_24_ring_explicit`` on each layer."""

    dense_baseline = False

    def setup(self, ctx, layers):
        p = ctx.world
        state = []
        for i, (rows, n, k) in enumerate(layers):
            a = data.dense_a(rows, k, ctx.seed, i, ctx.rank, ctx.device)
            s = sparse24.pack_wg(sparse24.compress_24(prune.prune_nm(a)[0]))
            kp = -(-k // 64) * 64  # the planes' k: B padded to it is sharded
            b = torch.nn.functional.pad(
                data.weight_b(k, n, ctx.seed, i, ctx.device),
                (0, 0, 0, kp - k))
            shard = b[ctx.rank * kp // p:(ctx.rank + 1) * kp // p].contiguous()
            state.append((s, shard, ctx.mesh))
        return state

    def run_pass(self, state, traced):
        out = []
        for s, b, mesh in state:
            with span(traced, "ring24"):
                out.append(ring_kernel.spmm_24_ring_explicit(
                    s, b, mesh, "model", out_dtype=BF16))
        return out

    def designs(self, state):
        out = []
        for s, b, mesh in state:
            k4s = s.values0.shape[-2] // mesh.shape["model"]
            mloc = s.values0.shape[-1]
            out.append(ring_kernel.ring_design(
                s, b, out_dtype=BF16, mloc=mloc, mt=mloc, k4s=k4s))
        return out


ROUTES = {"sparse24_static": Static24, "sparse24_pipeline": Pipeline24,
          "ell": Ell, "sparse24_ring": Ring24}


def load_file(path: Path, name: str):
    """The module in the file ``path``, loaded by path as ``name`` and
    entered in ``sys.modules`` first, as the import system does, so that a
    dataclass in it finds its module."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


_RESOLVED: dict = {}


def resolve(name: str, root: Path) -> type:
    """The route class of traffic route ``name``: one of :data:`ROUTES`,
    or the ``ROUTE`` of ``root/perfbench/model_routes/<name>.py``, whose
    file is run once a process and root."""
    if name in ROUTES:
        return ROUTES[name]
    path = (Path(root) / "perfbench" / "model_routes" / f"{name}.py").resolve()
    if path in _RESOLVED:
        return _RESOLVED[path]
    if not path.is_file():
        raise KeyError(f"route {name!r} is neither one of {sorted(ROUTES)} "
                       f"nor a file {path}")
    route = getattr(load_file(path, "perfbench_route_" + name.replace(
        ".", "_").replace("-", "_")), "ROUTE", None)
    if not (isinstance(route, type) and issubclass(route, Route)):
        raise TypeError(f"{path} has no ROUTE that is a routes.Route")
    _RESOLVED[path] = route
    return route
