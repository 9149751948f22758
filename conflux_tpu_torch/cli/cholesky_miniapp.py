"""Cholesky miniapp: CLI parity with examples/cholesky_miniapp.cpp.

PyTorch counterpart of `conflux_tpu/cli/cholesky_miniapp.py`, with its
flags: -N/--dim, -v/--tile, -g/--grid PxxPyxPz, -r/--run, --validate,
--profile, and --platform (the device: the card unless 'cpu') and
--force_devices (the number of ranks started; default: the grid's).
The products run in 'highest', as the JAX miniapp's. One process per
rank, as in conflux_miniapp.py; only grid rank 0 prints. Output is the `printTimings` block
(cholesky_miniapp.cpp:34-50) plus the `_result_` protocol of the LU
miniapp (library tag `psychol`, results/benchmarks.csv).
"""

from __future__ import annotations

import argparse
import sys

_MODULE = "conflux_tpu_torch.cli.cholesky_miniapp"


def _parser():
    ap = argparse.ArgumentParser(prog="cholesky_miniapp")
    ap.add_argument("-N", "--dim", type=int, default=4096)
    ap.add_argument("-v", "--tile", type=int, default=0, help="0 = auto heuristic")
    ap.add_argument("-g", "--grid", type=str, default=None, help="PxxPyxPz")
    ap.add_argument("-r", "--run", type=int, default=2, help="repetitions")
    ap.add_argument("--validate", action="store_true")
    ap.add_argument("--platform", default=None, help="cuda (default) or cpu")
    ap.add_argument("--force_devices", type=int, default=None,
                    help="ranks to start (default: the grid's)")
    ap.add_argument("--profile", action="store_true")
    return ap


def run(argv) -> None:
    """One rank's miniapp: every rank of the world runs it."""
    args = _parser().parse_args(argv)

    from conflux_tpu_torch.cli._common import (
        grid_device,
        parse_grid,
        setup_platform,
    )
    from conflux_tpu_torch.timing import timed_run

    device = setup_platform(args.platform)

    from conflux_tpu_torch import profiler
    from conflux_tpu_torch.cholesky.p25d import cholesky_25d
    from conflux_tpu_torch.grid import choose_tile_cholesky, make_grid
    from conflux_tpu_torch.io import spd_matrix
    from conflux_tpu_torch.layout import BlockCyclic, distribute
    from conflux_tpu_torch.pgemm import pchol_residual_25d

    if args.profile:
        profiler.enable(True)

    N = args.dim
    grid = make_grid(parse_grid(args.grid), device=grid_device(device), N=N,
                     algorithm="cholesky")
    if grid.idle:
        return
    say = print if grid.rank == 0 else (lambda *a, **k: None)
    v = args.tile or choose_tile_cholesky(N, (grid.Px, grid.Py, grid.Pz), grid.P)
    v = min(v, N)

    with profiler.region("init_matrix"):
        A = spd_matrix(N, v=min(v, 256), seed=42)
        desc = BlockCyclic.create(N, N, v, grid)
        G = distribute(A, desc)

    def run_chol(g):
        return cholesky_25d(g, desc)

    # warm-up (reference: cholesky_miniapp.cpp:105-107)
    with profiler.region("warmup_compile"):
        _, L = timed_run(run_chol, G, device=device)

    times = []
    for rep in range(args.run):
        L = None                      # the previous factor's memory is free
        with profiler.region("cholesky_rep"):
            ms, L = timed_run(run_chol, G, device=device)
        times.append(ms)
        say(f"_result_ cholesky,psychol,{N},{N},{grid.P},{grid},"
            f"time,strong,{ms:.3f},{v}")

    # printTimings parity (cholesky_miniapp.cpp:34-50)
    say(f"N={N}, v={v}, grid={grid}, P={grid.P}")
    if times:
        say(f"runs={len(times)} min={min(times):.3f}ms "
            f"mean={sum(times)/len(times):.3f}ms max={max(times):.3f}ms")

    if args.validate:
        # distributed residual on the user's unpadded N (padding masked)
        res = float(pchol_residual_25d(G, L, desc, n_true=N))
        say(f"_result_ cholesky,psychol,{N},{N},{grid.P},{grid},"
            f"residual,strong,{res:.3e},{v}")

    if args.profile:
        # the timed reps' tree: on -g 1x1x1 the flat Cholesky's step spans
        # (chol.factor and its phases), host and stream time
        if grid.rank == 0:
            profiler.PP()
        # per-substep attribution (reference: PE(reduceA11_reduction) /
        # PE(choleskyA00_compute) / PE(updateA10_*) / PE(computeA11_dgemm)
        # throughout Cholesky.cpp:188-715 + PP(), CholeskyProfiler.h:17-32):
        # one fenced run of the substep-split program, the same math as
        # the unprofiled one; per-substep RATIOS are the signal
        from conflux_tpu_torch.cholesky.profiled import cholesky_25d_profiled

        cholesky_25d_profiled(G, desc)
        profiler.PC()
        with profiler.region("cholesky_profiled_total"):
            cholesky_25d_profiled(G, desc)
        if grid.rank == 0:
            profiler.PP()


def main(argv=None) -> int:
    from conflux_tpu_torch.cli._common import start

    argv = sys.argv[1:] if argv is None else argv
    args = _parser().parse_args(argv)
    return start(_MODULE, argv, args.platform, args.grid,
                 args.force_devices)


if __name__ == "__main__":
    sys.exit(main())
