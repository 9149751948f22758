"""LU miniapp: CLI parity with examples/conflux_miniapp.cpp.

PyTorch counterpart of `conflux_tpu/cli/conflux_miniapp.py`, with its
flags: -M/--rows, -N/--cols, -b/--block_size, -p/--p_grid PxxPyxPz,
-r/--n_rep, -t/--type weak|strong, -l/--print_limit, --pivoting,
--validate, --profile, and --platform (the device: the card unless
'cpu') and --force_devices (the number of ranks started; default: the
grid's). --precision sets the trailing-update products (default
'highest', the JAX miniapp's). One process per rank: under torchrun each
rank runs this; otherwise a world of more than one rank is started here
(cli/_common.py) and only grid rank 0 prints.

    python -m conflux_tpu_torch.cli.conflux_miniapp -N 16384 -b 512 -p 2x2x2
    torchrun --nproc-per-node 8 -m conflux_tpu_torch.cli.conflux_miniapp ...

Output protocol parity (conflux_miniapp.cpp:156-165): one machine-parsable
line per repetition:
  _result_ lu,conflux-tpu,<N>,<N_base>,<P>,<PxxPyxPz>,time,<type>,<ms>,<v>
"""

from __future__ import annotations

import argparse
import math
import sys

_MODULE = "conflux_tpu_torch.cli.conflux_miniapp"


def _parser():
    ap = argparse.ArgumentParser(prog="conflux_miniapp")
    ap.add_argument("-M", "--rows", type=int, default=0)
    ap.add_argument("-N", "--cols", type=int, default=4096)
    ap.add_argument("-b", "--block_size", type=int, default=256)
    ap.add_argument("-p", "--p_grid", type=str, default=None, help="PxxPyxPz")
    ap.add_argument("-r", "--n_rep", type=int, default=2)
    ap.add_argument("-t", "--type", choices=["weak", "strong"], default="strong")
    ap.add_argument("-l", "--print_limit", type=int, default=32,
                    help="print matrices when N <= limit (debug)")
    ap.add_argument("--pivoting", default="tournament",
                    choices=["tournament", "gather", "full", "none"])
    ap.add_argument("--precision", default="highest",
                    choices=["highest", "high", "bf16"])
    ap.add_argument("--validate", action="store_true",
                    help="compute ||PA-LU||/(N||A||) (reference: "
                         "CONFLUX_WITH_VALIDATION build)")
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
    from conflux_tpu_torch.grid import make_grid
    from conflux_tpu_torch.io import random_matrix
    from conflux_tpu_torch.layout import BlockCyclic, distribute, undistribute
    from conflux_tpu_torch.lu.p25d import lu_25d
    from conflux_tpu_torch.pgemm import plu_residual_25d

    if args.profile:
        profiler.enable(True)

    N = args.cols
    M = args.rows or N
    v = args.block_size
    grid = make_grid(parse_grid(args.p_grid), device=grid_device(device),
                     M=M, N=N, algorithm="lu")
    if grid.idle:
        return
    say = print if grid.rank == 0 else (lambda *a, **k: None)
    # weak scaling: exactly like the reference (conflux_miniapp.cpp:136-137),
    # -N is the GLOBAL problem and N_base = N/sqrt(P) is derived for the
    # _result_ line; the problem itself is never rescaled
    N_base = N // max(1, math.isqrt(grid.P)) if args.type == "weak" else N

    with profiler.region("init_matrix"):
        A = random_matrix(M, N, seed=42)
        desc = BlockCyclic.create(M, N, v, grid)
        G = distribute(A, desc)

    if N <= args.print_limit:
        say(A)

    def run_lu(g):
        return lu_25d(g, desc, args.pivoting, args.precision)

    # warm-up (kernel builds, allocator) + timed repetitions, reference
    # loop shape (conflux_miniapp.cpp:138-167)
    with profiler.region("warmup_compile"):
        _, (F, perm) = timed_run(run_lu, G, device=device)
    for rep in range(args.n_rep):
        F = perm = None               # the previous factor's memory is free
        with profiler.region("lu_rep"):
            ms, (F, perm) = timed_run(run_lu, G, device=device)
        say(
            f"_result_ lu,conflux-tpu,{N},{N_base},{grid.P},{grid},"
            f"time,{args.type},{ms:.3f},{v}"
        )

    if args.validate:
        # fully distributed ||PA-LU||/(N||A||), the in-framework version of
        # the reference's ScaLAPACK validation plane (padding masked)
        res = float(plu_residual_25d(G, F, perm, desc, n_true=N, m_true=M))
        say(f"_result_ lu,conflux-tpu,{N},{N_base},{grid.P},{grid},"
            f"residual,{args.type},{res:.3e},{v}")
        if N <= args.print_limit:
            Fd = undistribute(F, desc)       # a collective: every rank
            if Fd is not None:
                say(Fd.cpu().numpy())

    if args.profile:
        # the timed reps' tree: on -p 1x1x1 the single-card scheme's step
        # spans (lu.factor and its phases), host and stream time
        if grid.rank == 0:
            profiler.PP()
        if M == N:
            # per-substep attribution (reference: PE(step0_reduce)... +
            # PP(), src/conflux/lu/profiler.hpp:5-19): one fenced run of
            # the substep-split program, the same math as the unprofiled
            # one; per-substep RATIOS are the signal (each fence waits for
            # the device, lu/profiled.py)
            from conflux_tpu_torch.lu.profiled import lu_25d_profiled

            lu_25d_profiled(G, desc, args.pivoting, args.precision)
            profiler.PC()
            with profiler.region("lu_profiled_total"):
                lu_25d_profiled(G, desc, args.pivoting, args.precision)
            if grid.rank == 0:
                profiler.PP()


def main(argv=None) -> int:
    from conflux_tpu_torch.cli._common import start

    argv = sys.argv[1:] if argv is None else argv
    args = _parser().parse_args(argv)
    return start(_MODULE, argv, args.platform, args.p_grid,
                 args.force_devices)


if __name__ == "__main__":
    sys.exit(main())
