"""Benchmark result visualization (port of ``tabmat_tpu/bench/visualize.py``,
the counterpart of the upstream ``benchmark/visualize_benchmarks.py``:
relative-time bar charts).

Reads the CSV produced by ``python -m tabmat_torch.bench.main --output
results.csv`` and renders one grouped horizontal bar chart per operation,
showing each library's time normalized to tabmat_torch's (1.0 = parity;
>1 = slower than tabmat_torch).  ``matplotlib`` is imported inside the plot
functions only::

    python -m tabmat_torch.bench.visualize results.csv --output chart.png

Chart conventions: single axis; two fixed categorical hues (validated
palette slots 1–2); thin bars with a surface gap; direct value labels in
text ink; recessive grid.
"""

import argparse
import csv
from collections import defaultdict

# validated categorical palette, fixed slot order (light mode)
SERIES_COLORS = {"tabmat_torch": "#2a78d6", "numpy/scipy": "#eb6834"}
TEXT_PRIMARY = "#1a1a19"
TEXT_SECONDARY = "#5f5e56"
GRID = "#e6e4dd"


def load_results(path):
    rows = []
    with open(path, newline="") as f:
        for row in csv.DictReader(f):
            # merged multi-design CSVs tag standardized variants in a
            # column; fold the tag into the design name so rows don't
            # collide in the charts
            if str(row.get("standardized", "")).lower() == "true":
                row = dict(row, matrix=row["matrix"] + "_std")
            rows.append(row)
    return rows


def plot_relative(rows, output="benchmarks.png"):
    """One panel per op; bars = time relative to tabmat_torch per design."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    ops = sorted({r["operation"] for r in rows})
    by_key = defaultdict(dict)  # (op, matrix) -> {library: time}
    for r in rows:
        by_key[(r["operation"], r["matrix"])][r["library"]] = float(r["time_s"])

    fig, axes = plt.subplots(
        1, len(ops), figsize=(5.5 * len(ops), 4.2), squeeze=False
    )
    for ax, op in zip(axes[0], ops):
        designs = sorted({m for (o, m) in by_key if o == op})
        libs = ["tabmat_torch", "numpy/scipy"]
        height = 0.38
        for li, lib in enumerate(libs):
            ys, xs = [], []
            for di, design in enumerate(designs):
                times = by_key[(op, design)]
                base = times.get("tabmat_torch")
                if base is None or lib not in times:
                    continue
                ys.append(di + (li - 0.5) * (height + 0.04))
                xs.append(times[lib] / base)
            ax.barh(
                ys,
                xs,
                height=height,
                color=SERIES_COLORS[lib],
                label=lib,
                edgecolor="white",
                linewidth=1,
            )
            for y, x in zip(ys, xs):
                ax.text(
                    x * 1.02, y, f"{x:.2f}×", va="center", fontsize=8,
                    color=TEXT_SECONDARY,
                )
        ax.set_yticks(range(len(designs)))
        ax.set_yticklabels(designs, fontsize=9, color=TEXT_PRIMARY)
        ax.axvline(1.0, color=TEXT_SECONDARY, linewidth=1, linestyle=":")
        ax.set_xlabel("time relative to tabmat_torch", color=TEXT_SECONDARY)
        ax.set_title(op, color=TEXT_PRIMARY)
        ax.grid(axis="x", color=GRID, linewidth=0.8)
        ax.set_axisbelow(True)
        for spine in ("top", "right", "left"):
            ax.spines[spine].set_visible(False)
    axes[0][0].legend(frameon=False, fontsize=9)
    fig.tight_layout()
    fig.savefig(output, dpi=150)
    return output


def plot_memory(rows, output="benchmarks_mem.png"):
    """Per-op device-memory chart: structural caches vs total device memory.

    The upstream CLI charts host peak RSS per op (its
    ``visualize_benchmarks.py``); the analogous device resource here is
    the card's memory — the structural caches (`hbm_cache_bytes`) and the
    total held after the op (`hbm_total_bytes`).
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    rows = [r for r in rows if r.get("hbm_total_bytes") not in (None, "")]
    if not rows:
        return None
    ops = sorted({r["operation"] for r in rows})
    by_key = {}
    for r in rows:
        by_key[(r["operation"], r["matrix"])] = (
            float(r.get("hbm_cache_bytes") or 0) / 2**30,
            float(r["hbm_total_bytes"]) / 2**30,
        )

    fig, axes = plt.subplots(
        1, len(ops), figsize=(5.5 * len(ops), 4.2), squeeze=False
    )
    series = [("structural caches", 0, SERIES_COLORS["tabmat_torch"]),
              ("total device memory", 1, SERIES_COLORS["numpy/scipy"])]
    height = 0.38
    for ax, op in zip(axes[0], ops):
        designs = sorted({m for (o, m) in by_key if o == op})
        for li, (label, idx, color) in enumerate(series):
            ys, xs = [], []
            for di, design in enumerate(designs):
                ys.append(di + (li - 0.5) * (height + 0.04))
                xs.append(by_key[(op, design)][idx])
            ax.barh(ys, xs, height=height, color=color, label=label,
                    edgecolor="white", linewidth=1)
            for y, x in zip(ys, xs):
                ax.text(x * 1.02, y, f"{x:.2f}", va="center", fontsize=8,
                        color=TEXT_SECONDARY)
        ax.set_yticks(range(len(designs)))
        ax.set_yticklabels(designs, fontsize=9, color=TEXT_PRIMARY)
        ax.set_xlabel("device memory (GiB)", color=TEXT_SECONDARY)
        ax.set_title(op, color=TEXT_PRIMARY)
        ax.grid(axis="x", color=GRID, linewidth=0.8)
        ax.set_axisbelow(True)
        for spine in ("top", "right", "left"):
            ax.spines[spine].set_visible(False)
    axes[0][0].legend(frameon=False, fontsize=9)
    fig.tight_layout()
    fig.savefig(output, dpi=150)
    return output


def main(argv=None):
    """Render relative-performance charts from a benchmark CSV."""
    parser = argparse.ArgumentParser(prog="python -m tabmat_torch.bench.visualize",
                                     description=main.__doc__)
    parser.add_argument("csv_path")
    parser.add_argument("--output", default="benchmarks.png")
    parser.add_argument("--memory_output", default=None,
                        help="also render the device-memory chart to this path")
    args = parser.parse_args(argv)
    rows = load_results(args.csv_path)
    path = plot_relative(rows, args.output)
    print(f"wrote {path}")
    if args.memory_output:
        mpath = plot_memory(rows, args.memory_output)
        print(f"wrote {mpath}" if mpath else "no device-memory columns; skipped")


if __name__ == "__main__":
    main()
