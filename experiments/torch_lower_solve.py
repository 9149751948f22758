#!/usr/bin/env python3
"""Crout's winners' solve on the card: the blocked solve with the
hand-written diagonal kernel against the 32-wide inverse chain it replaces.

    python3 -m experiments.torch_lower_solve [--rows 256 --rows 512]
        [--dtype float32 --dtype float64] [--n 32768 --n 16384]
        [--lib NAME=DIR] [--factor] [--quick]

At every solve shape of crout's step loop at N (w = 1536 rows, c = N - k -
w columns for each step with k + w < N), on L from a partial-pivoting LU
(|l| <= 1) and random B: each variant's result against the float64 solve
within 2 eps kappa_inf(L) max|B|, its device time per call (calls captured
in a CUDA graph, no host launch work), its time per call back to back
(`timing.per_call_ms`, the host's launch work included), and its kernels
per call (torch.profiler). Variants: the chain (`_solve_unit_lower_blocked`
on `unit_lower(lu)`, what crout ran before), the blocked solve at each
--rows block height (with the package's kernel, and with the
`lower_solve.cu` of each --lib directory, built here with the package's
flags), `torch.linalg.solve_triangular` as a yardstick. Sums
per N and dtype close each table. --factor then times crout factorizations
at each N, the chain and the blocked solve in turns (`tri._LSOLVE_DTYPES`
emptied sends every solve to the chain), with their launches. Imports no
jax.
"""

import argparse
import ctypes
import statistics
import subprocess
import time

import torch
from torch.profiler import DeviceType, ProfilerActivity, profile

from conflux_tpu_torch.ops import _build, cuda_lower_solve, tri
from conflux_tpu_torch.timing import per_call_ms

W = 1536


def graph_ms(fn, calls=10, reps=5):
    """Device ms per call of fn(): `calls` calls in one CUDA graph, the
    median over `reps` replays."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def kernels_per_call(fn) -> int:
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) \
            as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA)


def winners_lu(dtype):
    """lu_top of a [2W, W] random block's partial-pivoting LU: its top W
    rows' merged factors, row-major, |l| <= 1."""
    g = torch.Generator().manual_seed(7)
    A = torch.randn(2 * W, W, generator=g, dtype=torch.float64)
    LU, _ = torch.linalg.lu_factor(A)
    return LU[:W].to("cuda", dtype).contiguous()


def build_lib(name, directory):
    """The diagonal kernel of DIRECTORY/lower_solve.cu, built with the
    package's flags, loaded as the package's wrapper loads its own."""
    out = f"{directory}/liblower_solve_{name}.so"
    subprocess.run([_build._nvcc(), *_build._FLAGS, "-o", out,
                    f"{directory}/lower_solve.cu"], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(out)
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.conflux_lower_solve.argtypes = [p, ll, ll, p, ll, p, ll, i, i, i, p]
    lib.conflux_lower_solve.restype = i
    lib.conflux_lower_solve_error_string.argtypes = [i]
    lib.conflux_lower_solve_error_string.restype = ctypes.c_char_p
    return lib


def solve_with_rows(rows, lib=None):
    def solve(lu, B, X):
        saved = tri._LSOLVE_ROWS, cuda_lower_solve._lib
        tri._LSOLVE_ROWS = rows
        if lib is not None:
            cuda_lower_solve._lib = lib
        try:
            tri.trsm_left_lower_unit_into(lu, B, X)
        finally:
            tri._LSOLVE_ROWS, cuda_lower_solve._lib = saved
    return solve


def shapes(n):
    return [n - k - W for k in range(0, n, W) if k + W < n]


def run_solves(n, dtype, rows_list, quick, libs):
    lu = winners_lu(dtype)
    L64 = torch.tril(lu.double(), -1) + torch.eye(W, dtype=torch.float64,
                                                  device="cuda")
    kappa = float(L64.abs().sum(1).max()
                  * torch.linalg.inv(L64).abs().sum(1).max())
    eps = torch.finfo(dtype).eps
    L = L64.to(dtype)
    cols = shapes(n)
    if quick:
        cols = cols[:1] + cols[-1:]
    names = (["chain"] + [f"rows {r}" for r in rows_list]
             + [f"{nm} rows {r}" for nm in libs for r in rows_list]
             + ["library"])
    sums = {nm: [0.0, 0.0] for nm in names}
    for c in cols:
        g = torch.Generator(device="cuda").manual_seed(c)
        B0 = torch.randn(W, c, generator=g, device="cuda", dtype=dtype)
        ref = torch.linalg.solve_triangular(L64, B0.double(), upper=False,
                                            unitriangular=True)
        tol = 2 * eps * kappa * float(B0.abs().max())
        B = B0.clone()
        X = torch.empty_like(B0)
        fns = {"chain": lambda: tri._solve_unit_lower_blocked(
                   tri.unit_lower(lu), B),
               "library": lambda: torch.linalg.solve_triangular(
                   L, B, upper=False, unitriangular=True)}
        for r in rows_list:
            fns[f"rows {r}"] = (lambda s=solve_with_rows(r):
                                s(lu, B, X))
            for nm, lib in libs.items():
                fns[f"{nm} rows {r}"] = (lambda s=solve_with_rows(r, lib):
                                         s(lu, B, X))
        row = []
        for nm in names:
            B.copy_(B0)
            out = fns[nm]()
            got = X if out is None else out
            torch.cuda.synchronize()
            diff = float((got.double() - ref).abs().max())
            # the blocked solve overwrites B, which the timed calls leave
            # drifting: a copy a call would add its own time, and the
            # values do not change the work
            dev = graph_ms(fns[nm])
            call = per_call_ms(fns[nm])
            nk = kernels_per_call(fns[nm])
            sums[nm][0] += dev
            sums[nm][1] += call
            ok = "ok" if diff <= tol else "FAIL"
            row.append(f"{nm} {dev:.4f}/{call:.4f} ms {nk} kernels "
                       f"diff {diff / tol:.3f} tol {ok}")
        print(f"N={n} {str(dtype)[6:]} [{W}, {c}] kappa {kappa:.3g}: "
              + "; ".join(row), flush=True)
        del B, B0, X, ref
        torch.cuda.empty_cache()
    print(f"N={n} {str(dtype)[6:]} sums over {len(cols)} solves "
          "(device / per call ms): "
          + ", ".join(f"{nm} {d:.3f} / {p:.3f}" for nm, (d, p)
                      in sums.items()), flush=True)


def run_factor(n, dtype, reps):
    from conflux_tpu_torch.lu.single import lu_factor
    from conflux_tpu_torch.validation import lu_residual_blocked

    g = torch.Generator(device="cuda").manual_seed(42)
    A = (5.0 + torch.rand(n, n, generator=g, device="cuda")).to(dtype)
    prec = "highest" if dtype == torch.float64 else "high"
    saved = tri._LSOLVE_DTYPES
    res = {"chain": [], "blocked": []}
    info = {}
    lu_factor(A, 1536, prec)                   # builds the kernels
    for turn in ("chain", "blocked", "blocked", "chain") * reps:
        tri._LSOLVE_DTYPES = () if turn == "chain" else saved
        before = cuda_lower_solve.LAUNCHES
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        F, perm = lu_factor(A, 1536, prec)
        torch.cuda.synchronize()
        res[turn].append((time.perf_counter() - t0) * 1e3)
        info[turn] = (cuda_lower_solve.LAUNCHES - before,
                      float(lu_residual_blocked(A, F, perm)))
        del F, perm
    tri._LSOLVE_DTYPES = saved
    for turn in ("chain", "blocked"):
        tri._LSOLVE_DTYPES = () if turn == "chain" else saved
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            lu_factor(A, 1536, prec)
            torch.cuda.synchronize()
        ev = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
        busy = sum(e.self_device_time_total for e in ev) / 1e3
        nk = sum(e.count for e in ev)
        tri._LSOLVE_DTYPES = saved
        print(f"factor N={n} {str(dtype)[6:]} {turn}: walls ms "
              f"{[round(t, 2) for t in res[turn]]}, median "
              f"{statistics.median(res[turn]):.2f}; kernels {nk}, device "
              f"busy {busy:.2f} ms (profiled); lower_solve launches "
              f"{info[turn][0]}, lu_residual_blocked {info[turn][1]:.3e}",
              flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, action="append")
    ap.add_argument("--dtype", action="append",
                    choices=("float32", "float64"))
    ap.add_argument("--n", type=int, action="append")
    ap.add_argument("--lib", action="append", default=[],
                    help="NAME=DIR: also time DIR/lower_solve.cu")
    ap.add_argument("--factor", action="store_true")
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--quick", action="store_true")
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}; torch {torch.__version__}", flush=True)
    t0 = time.perf_counter()
    cuda_lower_solve._load()
    print(f"lower_solve built and loaded in {time.perf_counter() - t0:.1f} "
          "s", flush=True)
    libs = {nm: build_lib(nm, d) for nm, d in
            (spec.split("=", 1) for spec in args.lib)}
    dtypes = [getattr(torch, d) for d in (args.dtype or ["float32"])]
    for n in args.n or [32768, 16384]:
        for dtype in dtypes:
            run_solves(n, dtype, args.rows or [256, 512], args.quick, libs)
    if args.factor:
        for n in args.n or [32768, 16384]:
            for dtype in dtypes:
                run_factor(n, dtype, args.reps)


if __name__ == "__main__":
    main()
