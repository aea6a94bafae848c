"""Sparse convolution layers: im2col + the 2:4 or Blocked-ELL SpMM.

Counterpart of ``sparsifyme_tpu.models.sparse_conv``. A conv layer whose
weight is stored sparse and whose forward IS the benchmarked sparse
matmul, so the shape sweep's numbers translate into layer latency:
:class:`SparseConv2d` runs kernel K3 on its 2:4-compressed weight (pruned
by K1 and compressed by K2 when it is built), :class:`EllConv2d` kernel K4
on its Blocked-ELL weight.

im2col mapping (the reference's accounting, `get_shapes.py:27-41`):
filters ``(out_ch, in_ch, kh, kw)`` reshape to ``(out_ch, in_ch*kh*kw)``
= the sparse A ``(n, k)``; input patches unfold to ``(batch*oh*ow,
in_ch*kh*kw)``; the product ``(batch*oh*ow, out_ch)`` folds back to
``(batch, oh, ow, out_ch)``. Layers take and return NHWC, as the JAX
layers do.

Padding follows XLA: ``"SAME"`` gives ``ceil(size / stride)`` outputs and
pads ``total // 2`` before and the rest after, so a 3x3 stride-2 conv on
an even size pads (0, 1), where ``F.conv2d(padding=1)`` would pad (1, 1);
``"VALID"`` pads nothing.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..containers import BlockedEll, Sparse24
from ..ops.ell import ell_from_dense, ell_to_dense, spmm_ell
from ..ops.prune import prune_nm
from ..ops.sparse24 import compress_24, decompress_24, spmm_24


def xla_padding(size: int, k: int, stride: int,
                padding: str) -> Tuple[int, int]:
    """``(before, after)`` padding of one spatial axis as XLA pads it."""
    if padding == "VALID":
        return 0, 0
    if padding != "SAME":
        raise ValueError(f"padding {padding!r}: use 'SAME' or 'VALID'")
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _pads(h: int, w: int, kh: int, kw: int, stride: int,
          padding: str) -> Tuple[int, int, int, int]:
    """``F.pad``'s ``(left, right, top, bottom)`` for XLA's padding."""
    return (*xla_padding(w, kw, stride, padding),
            *xla_padding(h, kh, stride, padding))


def conv_weight_as_matrix(w_oihw: torch.Tensor) -> torch.Tensor:
    """``(out_ch, in_ch, kh, kw)`` -> ``(out_ch, in_ch*kh*kw)``, matching
    :func:`im2col`'s feature order."""
    oc, ic, kh, kw = w_oihw.shape
    return w_oihw.reshape(oc, ic * kh * kw)


def _patch_columns(x: torch.Tensor, kh: int, kw: int, stride: int,
                   padding: str) -> Tuple[torch.Tensor, int, int]:
    """The SpMM's B, ``patches^T [in_ch*kh*kw, batch*oh*ow]``, gathered in
    one copy from a zero-padded NCHW copy of NHWC ``x``, where neighbouring
    outputs read neighbouring inputs (from the NHWC windows they would read
    ``2 * in_ch * stride`` bytes apart)."""
    b, h, w, c = x.shape
    left, right, top, bottom = _pads(h, w, kh, kw, stride, padding)
    xp = x.new_zeros((b, c, h + top + bottom, w + left + right))
    xp[:, :, top:top + h, left:left + w] = x.permute(0, 3, 1, 2)
    oh = (xp.shape[2] - kh) // stride + 1
    ow = (xp.shape[3] - kw) // stride + 1
    sb, sc, sh, sw = xp.stride()
    win = xp.as_strided((c, kh, kw, b, oh, ow),
                        (sc, sh, sw, sb, sh * stride, sw * stride))
    return win.reshape(c * kh * kw, b * oh * ow), oh, ow


def im2col(x: torch.Tensor, kh: int, kw: int, stride: int = 1,
           padding: str = "SAME") -> torch.Tensor:
    """Unfold NHWC input into patches ``(batch, oh, ow, in_ch*kh*kw)``,
    features ordered ``(in_ch, kh, kw)`` as XLA's
    ``conv_general_dilated_patches`` orders them, which is the order of the
    OIHW weight flatten (:func:`conv_weight_as_matrix`): the layers' B
    (:func:`_patch_columns`), transposed."""
    bt, oh, ow = _patch_columns(x, kh, kw, stride, padding)
    return bt.T.reshape(x.shape[0], oh, ow, -1)


def _dense_conv(x: torch.Tensor, w_oihw: torch.Tensor, stride: int,
                padding: str) -> torch.Tensor:
    """NHWC conv with an OIHW weight and XLA's padding, through
    ``F.conv2d`` (cuDNN on the card) in the promoted type; f32 without
    TF32."""
    dtype = torch.promote_types(x.dtype, w_oihw.dtype)
    kh, kw = w_oihw.shape[-2:]
    xp = F.pad(x.permute(0, 3, 1, 2).to(dtype),
               _pads(*x.shape[1:3], kh, kw, stride, padding))
    with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                    deterministic=False, allow_tf32=False):
        out = F.conv2d(xp, w_oihw.to(dtype), stride=stride)
    return out.permute(0, 2, 3, 1)


class SparseConv2d(nn.Module):
    """Conv layer with a 2:4-compressed weight; forward = 2:4 SpMM (K3).

    The weight matrix ``(out_ch, k)`` (k = in_ch*kh*kw) is pruned 2:4 along
    k, the contraction axis (K1), and compressed (K2) when the layer is
    built, on the weight's device. The forward computes ``spmm_24(W24,
    patches^T, transpose_out=True)``: the ``(batch*oh*ow, out_ch)`` result
    comes out patch-major with no transpose pass. The planes are
    parameters: the layer trains through :func:`spmm_24`'s backward.
    """

    def __init__(self, w_oihw: torch.Tensor, stride: int = 1,
                 padding: str = "SAME"):
        super().__init__()
        oc, ic, kh, kw = w_oihw.shape
        self.kh, self.kw, self.stride, self.padding = kh, kw, stride, padding
        self.out_ch, self.in_ch = oc, ic
        pruned, _ = prune_nm(conv_weight_as_matrix(w_oihw), 2, 4)
        s = compress_24(pruned)
        self.shape = s.shape
        self.values0 = nn.Parameter(s.values0)
        self.values1 = nn.Parameter(s.values1)
        self.register_buffer("codes", s.codes)

    @property
    def weight(self) -> Sparse24:
        return Sparse24(self.values0, self.values1, self.codes,
                        shape=self.shape)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """NHWC in -> NHWC out."""
        bt, oh, ow = _patch_columns(x, self.kh, self.kw, self.stride,
                                    self.padding)
        out = spmm_24(self.weight, bt, transpose_out=True)
        return out.reshape(x.shape[0], oh, ow, self.out_ch)

    def dense_weight(self) -> torch.Tensor:
        """The pruned weight, dense OIHW."""
        return decompress_24(self.weight).reshape(
            self.out_ch, self.in_ch, self.kh, self.kw)

    def dense_reference(self, x: torch.Tensor) -> torch.Tensor:
        """Oracle: the same conv with the pruned weight, a dense
        ``F.conv2d``. Used by the tests and the smoke run, never by the
        forward."""
        return _dense_conv(x, self.dense_weight(), self.stride, self.padding)


class EllConv2d(nn.Module):
    """Conv layer with a Blocked-ELL weight; forward = the Blocked-ELL
    gather SpMM (K4).

    The weight matrix ``(out_ch, k)``, k zero-padded to a multiple of the
    block width, keeps the top ``ell_blocks`` blocks per block-row (50%
    block sparsity by default, :func:`~..ops.ell.ell_from_dense`); the
    forward computes ``spmm_ell(W_ell, patches^T, transpose_out=True)``.
    Differentiable through ``values`` (the JAX VJP), as the JAX layer is.
    ``out_ch`` must be a multiple of ``block_size``.
    """

    def __init__(self, w_oihw: torch.Tensor, *, block_size: int = 128,
                 ell_blocks: Optional[int] = None, block_k: int = 0,
                 stride: int = 1, padding: str = "SAME"):
        super().__init__()
        oc, ic, kh, kw = w_oihw.shape
        self.kh, self.kw, self.stride, self.padding = kh, kw, stride, padding
        self.out_ch, self.in_ch = oc, ic
        wm = conv_weight_as_matrix(w_oihw)
        k = wm.shape[-1]
        bkb = block_k or block_size
        if oc % block_size:
            raise ValueError(f"out_ch {oc} must be a multiple of block_size "
                             f"{block_size}")
        kp = -(-k // bkb) * bkb
        if kp != k:
            wm = F.pad(wm, (0, kp - k))
        if ell_blocks is None:
            ell_blocks = max(1, (kp // bkb) // 2)  # 50% block sparsity
        self.k_padded = kp
        e = ell_from_dense(wm, block_size, ell_blocks, block_k)
        self.shape, self.block_size, self.block_k = (e.shape, e.block_size,
                                                     e.block_k)
        self.values = nn.Parameter(e.values)
        self.register_buffer("col_indices", e.col_indices)

    @property
    def weight(self) -> BlockedEll:
        return BlockedEll(self.values, self.col_indices, self.shape,
                          self.block_size, self.block_k)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """NHWC in -> NHWC out."""
        bt, oh, ow = _patch_columns(x, self.kh, self.kw, self.stride,
                                    self.padding)
        if bt.shape[0] != self.k_padded:
            bt = F.pad(bt, (0, 0, 0, self.k_padded - bt.shape[0]))
        out = spmm_ell(self.weight, bt, transpose_out=True)
        return out.reshape(x.shape[0], oh, ow, self.out_ch)

    def dense_weight(self) -> torch.Tensor:
        """The block-pruned weight, dense OIHW."""
        k = self.in_ch * self.kh * self.kw
        return ell_to_dense(self.weight)[:, :k].reshape(
            self.out_ch, self.in_ch, self.kh, self.kw)

    def dense_reference(self, x: torch.Tensor) -> torch.Tensor:
        """Oracle: the same conv with the block-pruned weight, a dense
        ``F.conv2d``. Used by the tests and the smoke run, never by the
        forward."""
        return _dense_conv(x, self.dense_weight(), self.stride, self.padding)
