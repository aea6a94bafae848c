"""SpMMA plan: the cusparseLt plan -> prune -> compress -> matmul lifecycle.

Counterpart of ``sparsifyme_tpu.plan`` (the reference's ``spmma()``,
``include/sparsify.me/spmma.hxx:21-118``). A plan pins the problem geometry
and the matmul formulation, runs the three phases (kernels K1, K2 and K3 on
CUDA tensors, their plain versions on CPU tensors: the plan runs where its
inputs lie), fuses prune and compress into one pass for ``plan(a, b)`` (the
K2 route of :func:`~.ops.sparse24.prune_compress_24`), caches a compressed
operand, and searches the formulations (``matmul_search``, the
``cusparseLtMatmulSearch`` analog). :func:`get_plan` keeps an LRU of plans
keyed on the full config.

Without an explicit tiling the plan reads the shape's ``spmm24`` entry of
the port's tuning table (:mod:`.bench.tuning`): K3's ``design``, ``tile``,
``packed`` codes and the ``fold``. Where its matmul can take K3's
``wgmma_sp`` route (bf16 in and out, ``batch * m`` a multiple of 128, n of
64, no tile, packed codes or fold in the entry, and an entry that does not
name ``mma_sp``), the compress step packs the route's operand once
(``ops.sparse24.pack_wg``) and the matmul takes the route; elsewhere it
takes the ``mma_sp`` tile. The TPU tiling fields (``block_m``, ``block_n``,
``block_k4``) and the candidate slots ``pipeline``, ``row_chunks`` and
``budget_mb`` keep the JAX shapes of :class:`SpmmaConfig` and
``plan.algorithm``; K3 has no such knobs, so an explicit tiling only keeps
the table out (``pick_tile`` tiles the launch), as it wins over the table
in JAX.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import warnings
from typing import Dict, Optional, Tuple

import torch

from . import _build
from .bench import tuning
from .containers import Sparse24
from .ops.kernels.spmm24_kernel import spmm24_cuda, spmm24_plain, wg_shape
from .ops.prune import prune_check_nm, prune_nm
from .ops.sparse24 import (compress_24, pack_codes_fp, pack_wg,
                           prune_compress_24, spmm_24)
from .utils.timing import Timing, time_kernel


def _dtype(name: str) -> torch.dtype:
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


def _dtype_name(dt: torch.dtype) -> str:
    return str(dt).removeprefix("torch.")


@dataclasses.dataclass(frozen=True)
class SpmmaConfig:
    """Problem geometry and formulation (the matmul descriptor and
    algorithm-selection analog, ``spmma.hxx:67-76``). ``dtype`` and
    ``out_dtype`` name torch dtypes (``"bfloat16"``, ``"float32"``)."""

    m: int
    n: int
    k: int
    batch: int = 1
    dtype: str = "bfloat16"
    out_dtype: str = "float32"
    block_m: Optional[int] = None
    block_n: Optional[int] = None
    block_k4: Optional[int] = None

    def key(self) -> Tuple:
        return dataclasses.astuple(self)


class SpmmaPlan:
    """prune -> compress -> matmul pipeline.

    Usage::

        plan = SpmmaPlan(SpmmaConfig(m, n, k, batch=b))
        pruned = plan.prune(a)             # phase 1  (spmma.hxx:85-88)
        ok     = plan.prune_check(pruned)  # PruneCheck (spmma.hxx:88-94)
        s      = plan.compress(pruned)     # phase 2  (spmma.hxx:100-103)
        c      = plan.matmul(s, b)         # phase 3  (spmma.hxx:112-113)

    or ``plan(a, b)`` for the fused pipeline. ``plan.set_operand(s)``
    caches the compressed operand for repeated ``plan.matmul_cached(b)``.
    """

    def __init__(self, config: SpmmaConfig):
        self.config = cfg = config
        self.out_dtype = _dtype(cfg.out_dtype)
        _dtype(cfg.dtype)
        self.aligned = not (cfg.k % 8 or cfg.m % 8)
        if not self.aligned:
            # The reference rejects sizes that are not multiples of 8
            # (spmma.hxx:45-49); the kernels here take them, slower.
            warnings.warn(
                f"SpmmaPlan m={cfg.m} k={cfg.k}: sizes not multiples of 8"
                " (the reference rejects these shapes, spmma.hxx:45-49);"
                " expect below-peak throughput", stacklevel=2)
        # An explicit tiling wins; otherwise the tuning table's spmm24
        # entry picks K3's tile, packed codes and the fold. transpose_out is
        # not taken from the table: plan.matmul returns row-major C, as
        # spmma does.
        entry: Dict = {}
        if cfg.block_m is None and cfg.block_n is None \
                and cfg.block_k4 is None:
            entry = (tuning.lookup(cfg.m, cfg.n, cfg.k, cfg.batch)
                     or {}).get("spmm24") or {}
        packed = bool(entry.get("packed"))
        self.tile: Optional[int] = entry.get("tile")
        self.algorithm = (cfg.block_m, cfg.block_n, cfg.block_k4, False,
                          True, packed)
        self._packed = packed
        self._operand: Optional[Sparse24] = None
        self._operand_packed: Optional[torch.Tensor] = None
        # A fold entry routes the whole fused pipeline through the fold=2
        # layout: prune_compress_24 emits folded planes and spmm_24
        # dispatches on the operand's fold.
        fold = int(entry.get("fold", 1) or 1)
        self._fold = fold if (fold > 1
                              and (cfg.batch * cfg.m) % fold == 0) else 1
        # K3's wgmma_sp route: its operand is packed in the compress step
        # where the matmul can take it and the entry does not name mma_sp
        design = entry.get("design")
        self._wg = (design != "mma_sp" and self.tile is None and not packed
                    and self._fold == 1
                    and self.out_dtype == torch.bfloat16
                    and wg_shape(cfg.batch * cfg.m, cfg.n, _dtype(cfg.dtype)))
        self.design: Optional[str] = (design if design != "wgmma_sp"
                                      or self._wg else None)
        self._matmul = functools.partial(spmm_24, out_dtype=self.out_dtype,
                                         packed_codes=packed, tile=self.tile,
                                         design=self.design)

    # -- phases --------------------------------------------------------
    def prune(self, a: torch.Tensor) -> torch.Tensor:
        return prune_nm(a, 2, 4)[0]

    def prune_check(self, a: torch.Tensor) -> bool:
        return prune_check_nm(a, 2, 4)

    def compress(self, a: torch.Tensor) -> Sparse24:
        """K2's planes, with K3's wgmma_sp operand where the plan takes
        that route."""
        return self._with_wg(compress_24(a))

    def matmul(self, s: Sparse24, b: torch.Tensor) -> torch.Tensor:
        return self._matmul(s, b)

    def __call__(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self._matmul(
            self._with_wg(prune_compress_24(a, fold=self._fold)), b)

    def _with_wg(self, s: Sparse24) -> Sparse24:
        return pack_wg(s) if self._wg and s.wg is None else s

    # -- operand caching (metadata reuse across batches) ----------------
    def set_operand(self, s: Sparse24) -> None:
        """Cache ``s``; with a packed-codes algorithm, pack its codes once
        here instead of on every call."""
        self._operand = self._with_wg(s)
        self._operand_packed = pack_codes_fp(s.codes) if self._packed \
            else None

    def matmul_cached(self, b: torch.Tensor) -> torch.Tensor:
        if self._operand is None:
            raise ValueError("no cached operand; call set_operand() first")
        if self._operand_packed is None:
            return self._matmul(self._operand, b)
        s = self._operand
        *lead, m, k = s.shape
        tout = bool(self.algorithm[3])
        fn = spmm24_cuda if _build.use_kernel(s.values0) else spmm24_plain
        out = fn(s.values0, s.values1, self._operand_packed, b, k_logical=k,
                 out_dtype=self.out_dtype, transpose_out=tout,
                 packed_codes=True, tile=self.tile)
        if tout:
            return out
        return out.reshape(*lead, m, out.shape[-1])

    # -- algorithm search (cusparseLtMatmulSearch analog) ---------------
    def matmul_search(
        self,
        s: Sparse24,
        b: torch.Tensor,
        *,
        candidates: Optional[Tuple[Tuple, ...]] = None,
        iters: int = 4,
        reps: int = 2,
    ) -> Tuple:
        """Time candidate formulations on ``(s, b)`` and pin the fastest
        into this plan; returns it (the ``alg_id`` analog). A candidate is
        ``(block_m, block_n, block_k4, transpose_out[, pipeline[, packed[,
        row_chunks[, budget_mb]]]])`` as in the JAX package; the tiling,
        ``pipeline``, ``row_chunks`` and ``budget_mb`` slots are ignored,
        and every candidate runs on the plan's :attr:`tile` (and, where it
        qualifies, its ``wgmma_sp`` route).
        The default races ``transpose_out`` and, where ``k <= 1024``,
        packed codes. A C^T winner makes ``matmul`` return C^T ``[n, M]``,
        as it does in the JAX package."""
        if candidates is None:
            candidates = ((None, None, None, False),
                          (None, None, None, True))
            if self.config.k <= 1024:  # split-half packing: one k-step
                candidates += ((None, None, None, False, True, True),
                               (None, None, None, True, True, True))
        best, best_ms = None, math.inf
        for cand in candidates:
            fn = self._formulation(cand)
            ms = time_kernel(fn, (s, b), iters=iters, reps=reps).ms
            if ms < best_ms:
                best, best_ms = cand, ms
        if best is None:
            raise ValueError("matmul_search: no candidates")
        self.algorithm = best
        self._packed = len(best) > 5 and bool(best[5])
        if self._operand is not None:
            self.set_operand(self._operand)  # refresh the pre-pack
        self._matmul = self._formulation(best)
        self._fold = 1
        return best

    def _formulation(self, cand: Tuple):
        # a candidate the wgmma_sp route cannot take keeps the mma_sp tile
        return functools.partial(
            spmm_24, out_dtype=self.out_dtype, transpose_out=bool(cand[3]),
            packed_codes=len(cand) > 5 and bool(cand[5]), tile=self.tile,
            design=None if self.design == "wgmma_sp" else self.design)

    # -- timed pipeline (the reference's return contract) ---------------
    def timed(self, a: torch.Tensor, b: torch.Tensor, *, iters: int = 8,
              reps: int = 3) -> Tuple[torch.Tensor, Dict[str, Timing]]:
        """Run the three phases, each timed separately: the ``{prune,
        compress, mul}`` triple of ``spmma.hxx:117``, plus ``fused``, the
        one-pass prune+compress that ``plan(a, b)`` runs. The prune phase
        times the full op (weights and mask), as the reference's kernel
        writes both."""
        pruned = self.prune(a)
        t_prune = time_kernel(lambda x: prune_nm(x, 2, 4), (pruned,),
                              iters=iters, reps=reps)
        s = self.compress(pruned)
        t_compress = time_kernel(compress_24, (pruned,), iters=iters,
                                 reps=reps)
        out = self._matmul(s, b)
        t_mul = time_kernel(self._matmul, (s, b), iters=iters, reps=reps)
        t_fused = time_kernel(
            functools.partial(prune_compress_24, fold=self._fold), (a,),
            iters=iters, reps=reps)
        return out, {"prune": t_prune, "compress": t_compress,
                     "mul": t_mul, "fused": t_fused}


@functools.lru_cache(maxsize=256)
def _plan_cache(key: Tuple) -> SpmmaPlan:
    return SpmmaPlan(SpmmaConfig(*key))


def get_plan(config: SpmmaConfig) -> SpmmaPlan:
    """Module-level plan cache (the ``cusparseLtInit`` amortization
    analog), keyed on the full config."""
    return _plan_cache(config.key())


def spmma(a: torch.Tensor, b: torch.Tensor, *,
          out_dtype: torch.dtype = torch.float32, timed: bool = False):
    """One-shot prune -> compress -> matmul (the reference's ``spmma()``
    free function, ``spmma.hxx:21-118``). With ``timed=True`` returns
    ``(C, {prune, compress, mul, fused})`` timings."""
    *lead, m, k = a.shape
    cfg = SpmmaConfig(m=m, n=b.shape[-1], k=k, batch=math.prod(lead),
                      dtype=_dtype_name(a.dtype),
                      out_dtype=_dtype_name(out_dtype))
    plan = get_plan(cfg)
    if timed:
        return plan.timed(a, b)
    return plan(a, b)
