"""Scaling plots from benchmarks.csv: a copy of `conflux_tpu/bench/plots.py`
(parity with the reference's R plotting pipeline,
results/scripts/scaling_plots.R): GFLOP/s derivation (2N^3/3 for LU,
N^3/3 for Cholesky, scaling_plots.R:30) and per-grid strong/weak scaling
curves. Matplotlib, headless, and optional: without it only the table
prints."""

from __future__ import annotations

import argparse
import csv
import sys
from collections import defaultdict


def _gflops(alg: str, n: int, ms: float) -> float:
    flops = (2.0 / 3.0 if alg == "lu" else 1.0 / 3.0) * n**3
    return flops / (ms / 1e3) / 1e9


def load(path: str):
    rows = []
    with open(path) as f:
        for r in csv.DictReader(f):
            if r["unit"] != "time":
                continue
            rows.append(r)
    return rows


def summarize(rows):
    """(algorithm, N, grid, blocksize) -> GFLOP/s at the best (min) time over
    reps — matching how BASELINE.md reads the reference CSV."""
    groups = defaultdict(list)
    for r in rows:
        groups[(r["algorithm"], int(r["N"]), r["grid"], r["blocksize"])].append(
            float(r["value"])
        )
    return {
        key: _gflops(key[0], key[1], min(vals)) for key, vals in groups.items()
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="conflux_plots")
    ap.add_argument("csv", nargs="?", default="results/benchmarks.csv")
    ap.add_argument("-o", "--out", default="results/scaling.png")
    args = ap.parse_args(argv)

    rows = load(args.csv)
    summary = summarize(rows)
    for key in sorted(summary):
        alg, n, grid, b = key
        print(f"{alg:10s} N={n:<8d} grid={grid:<10s} b={b:<6s} {summary[key]:8.1f} GF/s")

    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        print("matplotlib unavailable; table only", file=sys.stderr)
        return 0

    fig, ax = plt.subplots(figsize=(7, 5))
    series = defaultdict(list)
    for (alg, n, grid, b), gf in sorted(summary.items()):
        series[(alg, grid, b)].append((n, gf))
    for (alg, grid, b), pts in series.items():
        xs, ys = zip(*sorted(pts))
        ax.plot(xs, ys, marker="o", label=f"{alg} {grid} b={b}")
    ax.set_xscale("log", base=2)
    ax.set_yscale("log")
    ax.set_xlabel("N")
    ax.set_ylabel("GFLOP/s")
    ax.set_title("conflux-tpu scaling")
    ax.legend(fontsize=8)
    ax.grid(alpha=0.3)
    fig.tight_layout()
    fig.savefig(args.out, dpi=120)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
