"""Model-level front-ends: shape datasets and sparse layers/models.
Counterpart of ``sparsifyme_tpu.models``."""

from .resnet_shapes import (
    all_model_shapes,
    benchmark_shapes,
    resnet_conv_shapes,
)
from .sparse_conv import (EllConv2d, SparseConv2d, conv_weight_as_matrix,
                          im2col)
from .sparse_mlp import MlpConfig, forward, init_params, make_train_step

__all__ = [
    "EllConv2d",
    "MlpConfig",
    "SparseConv2d",
    "all_model_shapes",
    "benchmark_shapes",
    "conv_weight_as_matrix",
    "forward",
    "im2col",
    "init_params",
    "make_train_step",
    "resnet_conv_shapes",
]
