"""Benchmark plots: per-layer kernel times, speedups, COO crossover.

The port's own copy of ``sparsifyme_tpu.bench.plots`` (the reference's
harnesses end in grouped-bar plots: ``examples/profiling.py:46-56`` and
``profiling/python/gemm_coo_compare.py:63-81``), reading the port's
files: the CSV of ``harness.write_csv`` or ``harness.write_compare_csv``,
``profiling_cli``'s ``compare.csv``, and BASELINE config 2's JSON
(``configs.config2_coo_resnet101``). matplotlib is imported inside each
function, so the package imports where it is not installed.

Chart conventions: one value axis; categorical hues in a fixed order
(dense, prune, blocked-ELL, 2:4), never cycled; thin marks with a gap
between adjacent bars; a recessive grid; text in neutral ink.
"""

from __future__ import annotations

import csv
import math
from typing import Optional, Sequence

# Fixed categorical order (colorblind-validated default palette):
# slot 1 blue, slot 2 orange, slot 3 aqua, slot 4 yellow.
_SERIES = {
    "gemm": ("dense GEMM", "#2a78d6"),
    "prune": ("prune", "#eb6834"),
    "spmm": ("blocked-ELL SpMM", "#1baf7a"),
    "spmm24": ("2:4 SpMM", "#eda100"),
}
_INK = "#3d3d3a"
_GRID = "#e8e8e4"


def _setup_axes(ax, title: str, ylabel: str):
    ax.set_axisbelow(True)
    ax.grid(axis="y", color=_GRID, linewidth=0.8)
    for side in ("top", "right", "left"):
        ax.spines[side].set_visible(False)
    ax.spines["bottom"].set_color(_GRID)
    ax.tick_params(colors=_INK, labelsize=8, length=0)
    ax.set_title(title, color=_INK, fontsize=11, loc="left")
    ax.set_ylabel(ylabel, color=_INK, fontsize=9)


def plot_compare(
    results_csv: str,
    out_png: str,
    *,
    series: Sequence[str] = ("gemm", "prune", "spmm", "spmm24"),
    title: Optional[str] = None,
) -> str:
    """Grouped-bar per-layer kernel times from a `bench_results.csv`
    (harness schema) or reference-style `compare.csv`.

    The finished version of `examples/profiling.py:46-56`: per layer,
    one thin bar per kernel, ms on a single log axis (layer times span
    ~50x), legend + fixed hue order.
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import numpy as np

    with open(results_csv) as f:
        rows = list(csv.DictReader(f))
    if not rows:
        raise ValueError(f"{results_csv}: no data rows")

    def col(r, s):
        # harness schema uses *_ms names and `ell_ms` for the blocked-
        # ELL column; the reference schema uses bare kernel names with
        # `spmm` meaning blocked-ELL.
        for key in (s, f"{s}_ms", "ell_ms" if s == "spmm" else None):
            if key and key in r and r[key] not in ("", "nan"):
                try:
                    v = float(r[key])
                    return v if v == v else math.nan
                except ValueError:
                    return math.nan
        return math.nan

    layers = [int(r.get("layer", i)) for i, r in enumerate(rows)]
    data = {s: [col(r, s) for r in rows] for s in series}
    series = [s for s in series if any(v == v for v in data[s])]

    n_l = len(layers)
    n_s = len(series)
    width = 0.8 / n_s
    fig, ax = plt.subplots(
        figsize=(max(10, 0.28 * n_l), 4.2), dpi=150)
    x = np.arange(n_l)
    for i, s in enumerate(series):
        label, color = _SERIES.get(s, (s, "#9b9b94"))
        ax.bar(
            x + (i - (n_s - 1) / 2) * width,
            [v if v == v else 0.0 for v in data[s]],
            width * 0.92,  # surface gap between adjacent bars
            label=label, color=color, linewidth=0,
        )
    _setup_axes(
        ax,
        title or "Per-layer kernel time, ResNet-50 im2col shapes "
                 "(b=32, bf16, one H100)",
        "wall ms (log)",
    )
    ax.set_yscale("log")
    ax.set_xticks(x[:: max(1, n_l // 25)])
    ax.set_xticklabels([str(l) for l in layers[:: max(1, n_l // 25)]])
    ax.set_xlabel("layer", color=_INK, fontsize=9)
    leg = ax.legend(frameon=False, fontsize=8, ncol=n_s,
                    loc="upper right")
    for t in leg.get_texts():
        t.set_color(_INK)
    fig.tight_layout()
    fig.savefig(out_png)
    plt.close(fig)
    return out_png


def plot_speedup(
    results_csv: str,
    out_png: str,
    *,
    title: Optional[str] = None,
) -> str:
    """Per-layer best-sparse speedup vs dense (paired ratios) with the
    per-shape speed-of-light bound overlaid — the headline chart."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import numpy as np

    with open(results_csv) as f:
        rows = list(csv.DictReader(f))

    def fget(r, k):
        try:
            v = float(r.get(k, "nan"))
            return v if v == v else math.nan
        except ValueError:
            return math.nan

    layers = [int(r.get("layer", i)) for i, r in enumerate(rows)]
    best = [
        max([v for v in (fget(r, "ell_speedup"), fget(r, "spmm24_speedup"))
             if v == v] or [math.nan])
        for r in rows
    ]
    # Physics bound per layer: best of the 2:4 SoL speedup (the
    # sol_speedup column) and the ELL bound (measured dense over the
    # ELL speed-of-light time).
    sol = []
    for r in rows:
        cands = []
        sd = fget(r, "sol_speedup")
        if sd == sd:
            cands.append(sd)
        g, eell = fget(r, "gemm_ms"), fget(r, "ell_sol_ms")
        if g == g and eell == eell and eell > 0:
            cands.append(g / eell)
        sol.append(max(cands) if cands else math.nan)

    x = np.arange(len(layers))
    fig, ax = plt.subplots(figsize=(max(10, 0.25 * len(layers)), 4.0),
                           dpi=150)
    ax.bar(x, [v if v == v else 0.0 for v in best], 0.7,
           color=_SERIES["spmm"][1], linewidth=0, label="best sparse")
    ax.plot(x, sol, color=_INK, linewidth=1.2, linestyle="--",
            label="speed-of-light bound")
    ax.axhline(1.0, color=_SERIES["gemm"][1], linewidth=1.0,
               label="dense parity")
    _setup_axes(
        ax,
        title or "Best-sparse speedup vs dense GEMM per layer "
                 "(paired timing) with physics bound",
        "speedup (x)",
    )
    ax.set_xticks(x[:: max(1, len(layers) // 25)])
    ax.set_xticklabels(
        [str(l) for l in layers[:: max(1, len(layers) // 25)]])
    ax.set_xlabel("layer", color=_INK, fontsize=9)
    leg = ax.legend(frameon=False, fontsize=8, loc="upper right")
    for t in leg.get_texts():
        t.set_color(_INK)
    fig.tight_layout()
    fig.savefig(out_png)
    plt.close(fig)
    return out_png


def plot_coo_crossover(
    config2_json: str,
    out_png: str,
    *,
    title: Optional[str] = None,
) -> str:
    """COO-vs-dense speedup (conversion included) as a function of
    sparsity, per shape — the finished `gemm_coo_compare.py:63-81`
    chart, extended to locate the crossover sparsity."""
    import json

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    with open(config2_json) as f:
        d = json.load(f)
    rows = d.get("rows", [])
    by_shape = {}
    for r in rows:
        key = (r["m"], r["n"], r["k"], r.get("b", 1))
        by_shape.setdefault(key, []).append(
            (r["sparsity"], r.get("speedup_vs_dense", math.nan)))

    fig, ax = plt.subplots(figsize=(7, 4.4), dpi=150)
    hues = [v[1] for v in _SERIES.values()] + ["#e87ba4", "#008300"]
    shown = 0
    for i, (key, pts) in enumerate(sorted(by_shape.items())):
        pts.sort()
        xs = [p[0] for p in pts]
        ys = [p[1] for p in pts]
        label = "x".join(str(v) for v in key) if shown < 6 else None
        ax.plot(xs, ys, marker="o", markersize=4, linewidth=2,
                color=hues[i % len(hues)], label=label)
        shown += 1
    ax.axhline(1.0, color=_INK, linewidth=1.0, linestyle="--")
    ax.annotate("dense parity", xy=(0.02, 1.0), xycoords=("axes fraction",
                                                          "data"),
                color=_INK, fontsize=8, va="bottom")
    _setup_axes(
        ax,
        title or "Batched COO SpMM vs dense (conversion included) "
                 "across sparsity",
        "speedup vs dense (x, log)",
    )
    ax.set_yscale("log")
    ax.set_xlabel("sparsity", color=_INK, fontsize=9)
    leg = ax.legend(frameon=False, fontsize=7, loc="upper left")
    for t in leg.get_texts():
        t.set_color(_INK)
    fig.tight_layout()
    fig.savefig(out_png)
    plt.close(fig)
    return out_png
