"""sparsifyme_tpu_torch — the PyTorch/CUDA port of sparsifyme_tpu.

Mirrors the JAX package's module paths and public names. Tensors on a
CUDA device go through hand-written Hopper kernels (``csrc/``, built with
``nvcc`` for ``sm_90a`` at first use); tensors on the CPU go through each
kernel's plain PyTorch version. Nothing falls back from one to the other:
a CUDA tensor whose kernel cannot be built or launched raises.

This package imports torch, numpy and the standard library only.
"""

from .containers import BlockedEll, Sparse24
from .ops.ell import (ell_from_dense, ell_pack, ell_to_dense,
                      ell_values_kmajor, spmm_ell, spmm_ell_expand)
from .ops.gemm import batched_gemm, gemm_bf16, gemm_f32, gemm_f64
from .ops.prune import (
    prune_24,
    prune_block_topk,
    prune_check_24,
    prune_check_nm,
    prune_nm,
)
from .ops.sparse24 import (
    compress_24,
    decompress_24,
    pack_codes_fp,
    prune_compress_24,
    spmm_24,
    spmm_24_reference,
)
from .plan import SpmmaConfig, SpmmaPlan, get_plan, spmma
from .utils.shapes import LayerShape, read_shapes, write_shapes

__version__ = "0.1.0"

__all__ = [
    "BlockedEll",
    "LayerShape",
    "Sparse24",
    "SpmmaConfig",
    "SpmmaPlan",
    "batched_gemm",
    "compress_24",
    "decompress_24",
    "ell_from_dense",
    "ell_pack",
    "ell_to_dense",
    "ell_values_kmajor",
    "gemm_bf16",
    "gemm_f32",
    "gemm_f64",
    "get_plan",
    "pack_codes_fp",
    "prune_24",
    "prune_block_topk",
    "prune_check_24",
    "prune_check_nm",
    "prune_compress_24",
    "prune_nm",
    "read_shapes",
    "spmm_24",
    "spmm_24_reference",
    "spmm_ell",
    "spmm_ell_expand",
    "spmma",
    "write_shapes",
]
