"""sparsifyme_tpu_torch — the PyTorch/CUDA port of sparsifyme_tpu.

Mirrors the JAX package's module paths and public names. Tensors on a
CUDA device go through hand-written Hopper kernels (``csrc/``, built with
``nvcc`` for ``sm_90a`` at first use); tensors on the CPU go through each
kernel's plain PyTorch version. Nothing falls back from one to the other:
a CUDA tensor whose kernel cannot be built or launched raises.

This package imports torch, numpy and the standard library only.
"""

from .containers import BlockedEll, Coo, Sparse24, WgOperand
from .ops.coo import (coo_from_dense, coo_layout, coo_to_dense, coo_to_ell,
                      pack_coo, spmm_coo, spmm_coo_segmented)
from .ops.ell import (ell_from_dense, ell_pack, ell_to_dense,
                      ell_values_kmajor, spmm_ell, spmm_ell_expand)
from .ops.gemm import batched_gemm, gemm_bf16, gemm_f32, gemm_f64
from .ops.prune import (
    prune_24,
    prune_block_magnitude,
    prune_block_topk,
    prune_check_24,
    prune_check_nm,
    prune_nm,
    prune_threshold,
)
from .ops.sparse24 import (
    compress_24,
    decompress_24,
    pack_codes,
    pack_codes_fp,
    pack_wg,
    prune_compress_24,
    spmm_24,
    spmm_24_reference,
    unpack_codes,
)
from .parallel.mesh import Mesh, init_distributed, make_mesh, replicate, \
    shard_batch
from .parallel.ring_kernel import (ring_permute_b, spmm_24_ring_explicit,
                                   spmm_24_ring_tiled)
from .parallel.spmm_sharded import (spmm_24_batch_sharded, spmm_24_ring,
                                    spmm_24_row_sharded)
from .plan import SpmmaConfig, SpmmaPlan, get_plan, spmma
from .utils.shapes import LayerShape, read_shapes, write_shapes

__version__ = "0.1.0"

__all__ = [
    "BlockedEll",
    "Coo",
    "LayerShape",
    "Mesh",
    "Sparse24",
    "SpmmaConfig",
    "SpmmaPlan",
    "batched_gemm",
    "compress_24",
    "coo_from_dense",
    "coo_layout",
    "coo_to_dense",
    "coo_to_ell",
    "decompress_24",
    "ell_from_dense",
    "ell_pack",
    "ell_to_dense",
    "ell_values_kmajor",
    "gemm_bf16",
    "gemm_f32",
    "gemm_f64",
    "get_plan",
    "init_distributed",
    "make_mesh",
    "pack_codes",
    "pack_codes_fp",
    "pack_coo",
    "pack_wg",
    "prune_24",
    "prune_block_magnitude",
    "prune_block_topk",
    "prune_check_24",
    "prune_check_nm",
    "prune_compress_24",
    "prune_nm",
    "prune_threshold",
    "read_shapes",
    "replicate",
    "ring_permute_b",
    "shard_batch",
    "spmm_24",
    "spmm_24_batch_sharded",
    "spmm_24_reference",
    "spmm_24_ring",
    "spmm_24_ring_explicit",
    "spmm_24_ring_tiled",
    "spmm_24_row_sharded",
    "spmm_coo",
    "spmm_coo_segmented",
    "spmm_ell",
    "spmm_ell_expand",
    "spmma",
    "unpack_codes",
    "write_shapes",
    "WgOperand",
]
