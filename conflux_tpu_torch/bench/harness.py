"""Benchmark harness: strong/weak scaling sweeps + benchmarks.csv writer.

PyTorch counterpart of `conflux_tpu/bench/harness.py`: the reference's
experiment pipeline (SURVEY.md §6) as a sweep driver whose results
accumulate in the CSV schema of results/benchmarks.csv:

    algorithm,library,N,N_base,P,grid,unit,type,value,blocksize,chol_vers

so the reference's R plotting scripts would ingest these numbers
unchanged. Times are `timing.timed_reps` (one warm-up, then CUDA events
on the card; the host's clock on the CPU, when the caller asks for it).
A distributed sweep starts its grid's ranks through `launch.run_ranks`.
"""

from __future__ import annotations

import csv
import dataclasses
import math
import os
from typing import Iterable, List, Optional

CSV_HEADER = [
    "algorithm", "library", "N", "N_base", "P", "grid", "unit", "type",
    "value", "blocksize", "chol_vers",
]


@dataclasses.dataclass
class Result:
    algorithm: str
    library: str
    N: int
    N_base: int
    P: int
    grid: str
    unit: str
    type: str
    value: float
    blocksize: int
    chol_vers: str = ""

    def row(self) -> List[str]:
        return [str(getattr(self, k)) for k in CSV_HEADER]


def append_results(path: str, results: Iterable[Result]) -> None:
    new = not os.path.exists(path)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "a", newline="") as f:
        w = csv.writer(f)
        if new:
            w.writerow(CSV_HEADER)
        for r in results:
            w.writerow(r.row())


def _timed(fn, *args, reps: int, device: str) -> List[float]:
    from conflux_tpu_torch.timing import timed_reps

    times, _ = timed_reps(fn, *args, reps=reps, device=device)
    return times


def bench_lu_single(
    sizes: Iterable[int] = (2048, 4096, 8192),
    v: int = 512,
    precision: str = "highest",
    reps: int = 3,
    csv_path: Optional[str] = None,
    device: str = "cuda",
) -> List[Result]:
    """Single-card strong-scaling-in-N sweep of the flagship LU."""
    from conflux_tpu_torch.interop import from_numpy
    from conflux_tpu_torch.io import random_matrix
    from conflux_tpu_torch.lu.single import lu_factor

    results = []
    for n in sizes:
        vv = min(v, n)
        A = from_numpy(random_matrix(n, n, seed=42), device=device)
        for ms in _timed(lambda a: lu_factor(a, v=vv, precision=precision),
                         A, reps=reps, device=device):
            results.append(
                Result("lu", "conflux-tpu", n, n, 1, "1x1x1", "time",
                       "strong", round(ms, 3), vv, precision)
            )
    if csv_path:
        append_results(csv_path, results)
    return results


def _bench_rank(algorithm, shape, sizes, v, precision, pivoting, scaling,
                reps, device) -> List[Result]:
    """One rank's sweep: every rank of the grid's world runs it; grid rank
    0's results are the sweep's (None elsewhere)."""
    from conflux_tpu_torch.cholesky.p25d import cholesky_25d
    from conflux_tpu_torch.grid import make_grid
    from conflux_tpu_torch.io import random_matrix, spd_matrix
    from conflux_tpu_torch.layout import BlockCyclic, distribute
    from conflux_tpu_torch.lu.p25d import lu_25d

    grid = make_grid(shape, device=None if device == "cuda" else device)
    if grid.idle:
        return None
    results = []
    for n_base in sizes:
        n = n_base
        if scaling == "weak":
            n = n_base * max(1, int(round((grid.Px * grid.Py) ** 0.5)))
        vv = min(v, n)  # v need not divide Pz (nlayr = ceil(v/Pz))
        desc = BlockCyclic.create(n, n, vv, grid)
        if algorithm == "lu":
            G = distribute(random_matrix(n, n, seed=42), desc)

            def fn(g):
                return lu_25d(g, desc, pivoting, precision)
            lib = "conflux-tpu"
        else:
            G = distribute(spd_matrix(n, v=min(vv, 256), seed=42), desc)

            def fn(g):
                return cholesky_25d(g, desc, precision)
            lib = "psychol"
        for ms in _timed(fn, G, reps=reps, device=device):
            results.append(
                Result(algorithm, lib, n, n_base, grid.P, str(grid), "time",
                       scaling, round(ms, 3), vv, precision)
            )
    return results if grid.rank == 0 else None


def bench_distributed(
    algorithm: str,
    shape,
    sizes: Iterable[int],
    v: int = 256,
    precision: str = "highest",
    pivoting: str = "tournament",
    scaling: str = "strong",
    reps: int = 3,
    csv_path: Optional[str] = None,
    device: str = "cuda",
    world: Optional[int] = None,
) -> List[Result]:
    """Strong or weak scaling sweep of the distributed factorizations on a
    (Px, Py, Pz) grid: one rank in this process for (1, 1, 1), else
    `world` ranks (default: the grid's) started through
    `launch.run_ranks` (gloo), each on its card or, with device='cpu', on
    the CPU. Returns grid rank 0's results."""
    args = (algorithm, tuple(shape), list(sizes), v, precision, pivoting,
            scaling, reps, device)
    world = world or math.prod(shape)
    if world == 1:
        results = _bench_rank(*args)
    else:
        from conflux_tpu_torch.launch import run_ranks

        results = run_ranks(world, _bench_rank, *args, backend="gloo",
                            device=device)[0]
    if csv_path:
        append_results(csv_path, results)
    return results
