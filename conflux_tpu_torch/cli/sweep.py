"""Benchmark sweep driver: parity with the reference's launch pipeline.

PyTorch counterpart of `conflux_tpu/cli/sweep.py`. The reference renders
SLURM sbatch files from params*.ini (scripts/generate_launch_files*.py +
scripts/launch_on_daint.py) and archives results as benchmarks.csv. This
CLI reads the same ini configs (configs/*.ini, unchanged), runs each
[sweep*] section (a single-card LU sweep in this process, a distributed
one on its grid's ranks, started here through `launch.run_ranks`) and
appends to a CSV with the reference's exact schema
(results/benchmarks.csv header). --platform picks the device (the card
unless 'cpu'), --force_devices the number of ranks each distributed
section starts (default: its grid's).

Config example (see configs/params_example.ini):

    [sweep]
    algorithm = lu            ; lu | cholesky | lu_single
    type = strong             ; strong | weak
    sizes = 2048,4096,8192    ; global N (strong) or per-device N_base (weak)
    grid = 2x2x1
    tile = 256
    precision = high
    reps = 3
    csv = results/benchmarks.csv
"""

from __future__ import annotations

import argparse
import configparser
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="conflux_sweep")
    ap.add_argument("config", help="ini file with one or more [sweep*] sections")
    ap.add_argument("--platform", default=None, help="cuda (default) or cpu")
    ap.add_argument("--force_devices", type=int, default=None,
                    help="ranks each distributed section starts")
    args = ap.parse_args(argv)

    from conflux_tpu_torch.cli._common import parse_grid, setup_platform

    device = setup_platform(args.platform)

    from conflux_tpu_torch.bench.harness import bench_distributed, \
        bench_lu_single

    cfg = configparser.ConfigParser()
    if not cfg.read(args.config):
        print(f"cannot read {args.config}", file=sys.stderr)
        return 2

    for section in cfg.sections():
        if not section.startswith("sweep"):
            continue
        s = cfg[section]
        algo = s.get("algorithm", "lu")
        sizes = [int(x) for x in s.get("sizes", "2048").split(",")]
        reps = s.getint("reps", 3)
        csv_path = s.get("csv", "results/benchmarks.csv")
        precision = s.get("precision", "highest")
        if algo == "lu_single":
            res = bench_lu_single(
                sizes=sizes, v=s.getint("tile", 512), precision=precision,
                reps=reps, csv_path=csv_path, device=device,
            )
        else:
            res = bench_distributed(
                algo, parse_grid(s.get("grid", "1x1x1")), sizes=sizes,
                v=s.getint("tile", 256), precision=precision,
                pivoting=s.get("pivoting", "tournament"),
                scaling=s.get("type", "strong"), reps=reps,
                csv_path=csv_path, device=device, world=args.force_devices,
            )
        for r in res:
            print(
                f"_result_ {r.algorithm},{r.library},{r.N},{r.N_base},{r.P},"
                f"{r.grid},{r.unit},{r.type},{r.value},{r.blocksize}"
            )
        print(f"[{section}] {len(res)} rows -> {csv_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
