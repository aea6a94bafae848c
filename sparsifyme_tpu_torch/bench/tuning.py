"""Per-shape kernel-configuration table (the algorithm-cache analog).

Counterpart of ``sparsifyme_tpu.bench.tuning``: a JSON table, one entry per
``"{m}x{n}x{k}x{b}"`` key, holding the winning configuration of each op
family in the port's own knobs. The offline tuner
(``python -m sparsifyme_tpu_torch.bench.tune``) measures it on the card and
writes it beside this module; the harness's tuned path and
:class:`~..plan.SpmmaPlan` read it. Schema of an entry::

    "3136x128x1152x32": {
      "gemm":   {"fold": true, "ms": 0.1},
      "fused":  {"fold": 1, "ms": 0.17},
      "spmm24": {"design": "wgmma_sp", "tile": null,
                 "transpose_out": false, "packed": false, "fold": 1,
                 "block_n": null, "splits": null, "ms": 0.095},
      "ell":    {"formulation": "gather", "transpose_out": false,
                 "block_size": 128, "block_k": 64, "fold_first": false,
                 "block_n": 128, "splits": 1, "ms": 0.055},
      "card":   "NVIDIA H100 80GB HBM3, 700.00 W"
    }

``design`` is K3's tile: ``mma_sp`` (the sparse tile on the planes) or
``wgmma_sp`` (the ``wgmma.sp`` route on the operand ``pack_wg`` derives;
``block_n`` and ``splits`` force its plan, ``null``: ``wg_plan``'s pick); an
entry without it (tables older than that route) leaves the choice to
``spmm_24``'s rule. ``tile`` is an index of ``spmm24_kernel.SP_TILES``
(``null``: the kernel's ``pick_tile``); ``packed`` and ``fold`` name K3's
packed-codes and fold=2 routes. In the ``ell`` entry, ``block_n`` and
``splits`` force K4's Hopper-tile plan (``null``: ``ell_plan``'s pick,
always so for K5, whose plans the tuner does not race); ``formulation`` is
K4 (``gather``) or K5 (``expand``). ``ms`` is the tuner's reading,
``card`` the ``nvidia-smi
--query-gpu=name,power.limit`` line of the card that took it (``cpu`` for
a run on CPU tensors), since the winners depend on the card's SM count.
A shape without an entry takes the harness's untuned race, so the table
speeds the sweep up and never decides a result's correctness.
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
