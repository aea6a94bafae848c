"""Layer-shape records and CSV IO.

The port's own copy of ``sparsifyme_tpu.utils.shapes`` (importing that
module would import JAX through the package ``__init__``). The
equivalent of the reference's shape plumbing:
`util::read_shapes` CSV parser (reference `include/sparsify.me/util/util.hxx:36-61`)
and the `m,n,k,b` CSV contract used by `datasets/*.csv` and
`examples/profiling.py:4-17`.

The CSV schema is `m,n,k,b` with a header row. `m` is the im2col patch count
(output H*W of a conv), `n` the output channels, `k` = in_ch*kh*kw, and `b`
the batch size (32 in all bundled datasets).
"""

from __future__ import annotations

import csv
import io
from typing import Iterable, List, NamedTuple


class LayerShape(NamedTuple):
    """One GEMM problem shape derived from a conv layer (im2col)."""

    m: int
    n: int
    k: int
    b: int

    @property
    def flops(self) -> int:
        """Dense-equivalent FLOPs for the full batched matmul."""
        return 2 * self.m * self.n * self.k * self.b

    def nnz(self, sparsity: float = 0.5) -> int:
        """Nonzeros of the batched sparse operand A at a given sparsity."""
        return int(self.m * self.k * self.b * (1.0 - sparsity))


def read_shapes(path_or_text: str) -> List[LayerShape]:
    """Parse an ``m,n,k,b`` CSV (header skipped) into LayerShapes.

    Mirrors the capability of ``util::read_shapes``
    (reference ``util/util.hxx:36-61``): skips the header line, one shape
    per data row.  Accepts either a filesystem path or raw CSV text.
    """
    if "\n" in path_or_text or "," in path_or_text and not _looks_like_path(
        path_or_text
    ):
        f = io.StringIO(path_or_text)
        return _parse(f)
    with open(path_or_text, "r") as f:
        return _parse(f)


def _looks_like_path(s: str) -> bool:
    return "\n" not in s and (s.endswith(".csv") or "/" in s)


def _parse(f) -> List[LayerShape]:
    """Header-aware parse. Understands both the reference's bare
    ``m,n,k,b`` schema and our richer ``layer,m,n,k,b`` datagen output:
    named header columns win; headerless/unnamed rows fall back to the
    first four fields positionally."""
    reader = csv.reader(f)
    rows: List[LayerShape] = []
    cols = [0, 1, 2, 3]
    for i, row in enumerate(reader):
        if not row:
            continue
        if i == 0:
            try:
                int(row[0])
            except ValueError:
                names = [c.strip().lower() for c in row]
                if all(c in names for c in ("m", "n", "k", "b")):
                    cols = [names.index(c) for c in ("m", "n", "k", "b")]
                continue
        m, n, k, b = (int(row[c]) for c in cols)
        rows.append(LayerShape(m, n, k, b))
    return rows


def write_shapes(path: str, shapes: Iterable[LayerShape]) -> None:
    """Write shapes to the ``layer,m,n,k,b`` CSV schema (with header).
    The leading layer index is this library's extension; `read_shapes`
    accepts both this and the reference's bare ``m,n,k,b`` schema."""
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["layer", "m", "n", "k", "b"])
        for i, s in enumerate(shapes):
            w.writerow([i, s.m, s.n, s.k, s.b])
