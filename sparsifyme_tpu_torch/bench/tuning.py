"""Per-shape kernel-configuration table (the algorithm-cache analog).

Counterpart of ``sparsifyme_tpu.bench.tuning``: a JSON table mapping
``(m, n, k, b)`` to the winning configuration per op family, in the JAX
package's schema (``{"spmm24": {"transpose_out": ..., "packed": ...,
"fold": ...}, "ell": {...}, "gemm": {...}}``). :class:`~..plan.SpmmaPlan`
reads its ``spmm24`` entry. The port keeps its own file beside this module;
none is committed (the TPU's winners mean nothing on an H100), and
:func:`lookup` returns ``None`` while the file is missing. The tuner that
would write it (``bench/tune.py``) is not ported yet.
"""

from __future__ import annotations

import functools
import json
import os
from typing import Dict, Optional

TABLE_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "tuning_table.json")


def shape_key(m: int, n: int, k: int, b: int) -> str:
    return f"{m}x{n}x{k}x{b}"


@functools.lru_cache(maxsize=1)
def _load(path: str) -> Dict[str, Dict]:
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        return json.load(f)


def load_table(path: Optional[str] = None) -> Dict[str, Dict]:
    return _load(path or TABLE_PATH)


def lookup(m: int, n: int, k: int, b: int,
           path: Optional[str] = None) -> Optional[Dict]:
    """Table entry for a shape, or None."""
    return load_table(path).get(shape_key(m, n, k, b))


def save_table(table: Dict[str, Dict], path: Optional[str] = None) -> None:
    path = path or TABLE_PATH
    with open(path, "w") as f:
        json.dump(table, f, indent=1, sort_keys=True)
        f.write("\n")
    _load.cache_clear()
