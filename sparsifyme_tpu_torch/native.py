"""ctypes binding of the native host library ``libsparsifyme.so``.

The port's own binding of the C ABI of ``cpp/src/sparsifyme/capi.h`` (as
``sparsifyme_tpu.native`` binds it): host implementations of N:M prune,
2:4 compress and decompress, code packing, block pruning and the
Blocked-ELL build, which make the same selections as the port's ops. It
is a third oracle for the tests, on numpy f32 arrays, and no path of the
port runs it.

Build the library (no CUDA needed)::

    cmake -S cpp -B <dir> -G Ninja && cmake --build <dir> --target sparsifyme

then ``load("<dir>/libsparsifyme.so")``; with no path :func:`load` takes
``$SPARSIFYME_NATIVE_LIB``, else ``cpp/build/libsparsifyme.so``.
"""

from __future__ import annotations

import ctypes
import os
from typing import List, Optional, Tuple

import numpy as np

ENV = "SPARSIFYME_NATIVE_LIB"
DEFAULT_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "cpp",
    "build", "libsparsifyme.so")

_F32P = ctypes.POINTER(ctypes.c_float)
_U8P = ctypes.POINTER(ctypes.c_uint8)
_I32P = ctypes.POINTER(ctypes.c_int32)
_I64P = ctypes.POINTER(ctypes.c_int64)
_I64 = ctypes.c_int64
_INT = ctypes.c_int

# name: (restype, argtypes) of every function of capi.h
_SIGNATURES = {
    "sm_abi_version": (_INT, []),
    "sm_now_ms": (ctypes.c_double, []),
    "sm_read_shapes": (ctypes.c_long, [ctypes.c_char_p, _I64P,
                                       ctypes.c_long]),
    "sm_prune_nm_f32": (None, [_F32P, _I64, _I64, _INT, _INT, _F32P, _U8P]),
    "sm_prune_check_nm_f32": (_INT, [_F32P, _I64, _I64, _INT, _INT]),
    "sm_compress_24_f32": (None, [_F32P, _I64, _I64, _F32P, _F32P, _U8P]),
    "sm_decompress_24_f32": (None, [_F32P, _F32P, _U8P, _I64, _I64,
                                    _F32P]),
    "sm_pack_codes": (None, [_U8P, _I64, _U8P]),
    "sm_unpack_codes": (None, [_U8P, _I64, _U8P]),
    "sm_prune_block_f32": (None, [_F32P, _I64, _I64, _INT, _INT,
                                  ctypes.c_float, _F32P, _U8P]),
    "sm_ell_from_dense_f32": (None, [_F32P, _I64, _I64, _INT, _INT, _F32P,
                                     _I32P]),
}


def _f32(a) -> np.ndarray:
    return np.ascontiguousarray(a, np.float32)


def _u8(a) -> np.ndarray:
    return np.ascontiguousarray(a, np.uint8)


def _ptr(a: np.ndarray, kind):
    return a.ctypes.data_as(kind)


def _matrix(w) -> np.ndarray:
    w = _f32(w)
    if w.ndim != 2:
        raise ValueError(f"expected a 2-d matrix, got shape {w.shape}")
    return w


class NativeLib:
    """One loaded ``libsparsifyme.so``. Every function takes and returns
    numpy arrays on the host, in the library's own layouts (row-major,
    planes ``[rows, ceil(cols / 4)]``)."""

    def __init__(self, path: str):
        self.path = path
        self._lib = ctypes.CDLL(path)
        for name, (res, args) in _SIGNATURES.items():
            fn = getattr(self._lib, name)
            fn.restype, fn.argtypes = res, args

    def abi_version(self) -> int:
        return self._lib.sm_abi_version()

    def now_ms(self) -> float:
        return self._lib.sm_now_ms()

    def read_shapes(self, path: str,
                    max_rows: int = 4096) -> List[Tuple[int, ...]]:
        out = np.zeros((max_rows, 4), np.int64)
        n = self._lib.sm_read_shapes(path.encode(), _ptr(out, _I64P),
                                     max_rows)
        if n < 0:
            raise FileNotFoundError(path)
        return [tuple(int(x) for x in row) for row in out[:n]]

    def prune_nm(self, w, n: int = 2, m: int = 4):
        """``(pruned, mask)``: the ``n`` largest magnitudes of each group
        of ``m`` along a row, ties to the later position; a short last
        group keeps ``min(n, its length)``."""
        w = _matrix(w)
        if not 0 < m <= 64:
            raise ValueError(f"group size {m} not in 1..64")
        pruned = np.empty_like(w)
        mask = np.empty(w.shape, np.uint8)
        self._lib.sm_prune_nm_f32(_ptr(w, _F32P), *w.shape, n, m,
                                  _ptr(pruned, _F32P), _ptr(mask, _U8P))
        return pruned, mask

    def prune_check_nm(self, w, n: int = 2, m: int = 4) -> bool:
        w = _matrix(w)
        return bool(self._lib.sm_prune_check_nm_f32(_ptr(w, _F32P),
                                                    *w.shape, n, m))

    def compress_24(self, w):
        """``(v0, v1, codes)``, each ``[rows, ceil(cols / 4)]``."""
        w = _matrix(w)
        k4 = (w.shape[1] + 3) // 4
        v0 = np.empty((w.shape[0], k4), np.float32)
        v1 = np.empty_like(v0)
        codes = np.empty(v0.shape, np.uint8)
        self._lib.sm_compress_24_f32(_ptr(w, _F32P), *w.shape,
                                     _ptr(v0, _F32P), _ptr(v1, _F32P),
                                     _ptr(codes, _U8P))
        return v0, v1, codes

    def decompress_24(self, v0, v1, codes, cols: int) -> np.ndarray:
        v0, v1, codes = _f32(v0), _f32(v1), _u8(codes)
        rows, k4 = v0.shape
        if v1.shape != v0.shape or codes.shape != v0.shape \
                or k4 != (cols + 3) // 4:
            raise ValueError("planes must share [rows, ceil(cols / 4)]")
        w = np.empty((rows, cols), np.float32)
        self._lib.sm_decompress_24_f32(_ptr(v0, _F32P), _ptr(v1, _F32P),
                                       _ptr(codes, _U8P), rows, cols,
                                       _ptr(w, _F32P))
        return w

    def pack_codes(self, codes) -> np.ndarray:
        """Two codes a byte over the flattened array, the first in the low
        nibble; an odd count leaves the last high nibble zero."""
        flat = _u8(codes).reshape(-1)
        packed = np.empty((flat.size + 1) // 2, np.uint8)
        self._lib.sm_pack_codes(_ptr(flat, _U8P), flat.size,
                                _ptr(packed, _U8P))
        return packed

    def unpack_codes(self, packed, n: int) -> np.ndarray:
        packed = _u8(packed).reshape(-1)
        if packed.size < (n + 1) // 2:
            raise ValueError(f"{packed.size} bytes hold fewer than {n} codes")
        codes = np.empty(n, np.uint8)
        self._lib.sm_unpack_codes(_ptr(packed, _U8P), n, _ptr(codes, _U8P))
        return codes

    def prune_block(self, w, block=(2, 2), sparsity: float = 0.5):
        w = _matrix(w)
        pruned = np.empty_like(w)
        mask = np.empty(w.shape, np.uint8)
        self._lib.sm_prune_block_f32(_ptr(w, _F32P), *w.shape, block[0],
                                     block[1], sparsity, _ptr(pruned, _F32P),
                                     _ptr(mask, _U8P))
        return pruned, mask

    def ell_from_dense(self, w, block_size: int, ell_blocks: int):
        """``(values [rows, ell_blocks * block_size], col_indices [rows /
        block_size, ell_blocks])`` of square blocks, the largest Frobenius
        norms of each block-row (ties to the later column), indices
        ascending."""
        w = _matrix(w)
        rows, cols = w.shape
        if rows % block_size or cols % block_size \
                or not 0 < ell_blocks <= cols // block_size:
            raise ValueError(f"{w.shape} does not hold {ell_blocks} "
                             f"blocks of {block_size} a block-row")
        values = np.empty((rows, ell_blocks * block_size), np.float32)
        col_indices = np.empty((rows // block_size, ell_blocks), np.int32)
        self._lib.sm_ell_from_dense_f32(_ptr(w, _F32P), rows, cols,
                                        block_size, ell_blocks,
                                        _ptr(values, _F32P),
                                        _ptr(col_indices, _I32P))
        return values, col_indices


def load(path: Optional[str] = None) -> NativeLib:
    """Load ``path``, else ``$SPARSIFYME_NATIVE_LIB``, else
    ``cpp/build/libsparsifyme.so``; a missing file raises
    ``FileNotFoundError``."""
    path = path or os.environ.get(ENV) or DEFAULT_PATH
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"{path}: build it with cmake -S cpp -B <dir> -G Ninja && "
            "cmake --build <dir> --target sparsifyme")
    return NativeLib(path)
