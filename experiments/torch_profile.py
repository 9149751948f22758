#!/usr/bin/env python3
"""Device-time split of one factorization by the PyTorch port, on a card.

    python3 -m experiments.torch_profile --scheme flat [--pin-ab] \
        [--dtype float32|float64|bfloat16]

`--scheme` is crout, flat, recursive, cholesky, or swap or split (crout
with that compaction); `--dtype` the storage dtype (chip_smoke.py's dtype
paths: the same inputs made in float64 or rounded to bfloat16). At
N=32768, v=1536, 'high' (chip_smoke.py's paths and inputs), runs one
warm-up, then times REPS unprofiled runs with CUDA events, then
profiles one more run with torch.profiler and sums the self device time of
the `DeviceType.CUDA` rows of `key_averages()` by kernel group (the
`aten::` rows repeat their kernels' time and are left out). Prints the
groups in order, the device-busy total against the median unprofiled
wall time (the idle share; a negative one means the profiled run's device
time exceeded the unprofiled wall, and the numbers are not comparable), the
profiled run's peak device memory (A included), and the card's name and
power limit. With --pin-ab it first times the public entry point against
the same function without its IEEE fp32 pin (`__wrapped__`, precision.py)
in turns, REPS runs each, to show what the pin costs. Imports no jax.
"""

import argparse
import statistics
import subprocess
from collections import defaultdict

import torch
from torch.profiler import DeviceType, ProfilerActivity, profile

N, V, PRECISION = 32768, 1536, "high"
REPS = 2
# kernel-name substrings, first match wins
GROUPS = (
    ("split pass of K3 and K2", ("split_hi_lo_kernel",)),
    ("K3 schur_update_wgmma_kernel", ("schur_update_wgmma_kernel",)),
    ("K2 sub_matmul_bigk (+ split-K sum)", ("sub_matmul_bigk_kernel",
                                            "bigk_reduce_kernel")),
    # K2's bf16-operand entry (wgmma_bf16.cuh): its ping-pong and
    # cooperative routes; ahead of the cuBLAS group, whose keys match
    # "bf16"
    ("K2 bf16 entry ping-pong", ("sub_matmul_bf16_kernel",)),
    ("K2 bf16 entry cooperative", ("sub_matmul_bf16_coop_kernel",)),
    ("K5 scatter_rows_kernel", ("scatter_rows_kernel",)),
    ("K6 gather_rows_kernel", ("gather_rows_kernel",)),
    ("K5/K6 bulk_move_kernel (TMA bulk route)", ("bulk_move_kernel",)),
    ("K1 rank1 grid route", ("rank1_grid_kernel",)),
    ("K1 rank1 cluster route", ("rank1_cluster_kernel",)),
    ("K1 rank1 tile route", ("rank1_tile_kernel",)),
    # K1 in double: its grid, cluster and tile routes (rank1_f64_kernel:
    # the one grid route it had before them)
    ("K1 f64 grid route", ("rank1_f64_grid_kernel", "rank1_f64_kernel")),
    ("K1 f64 cluster route", ("rank1_f64_cluster_kernel",)),
    ("K1 f64 tile route", ("rank1_f64_tile_kernel",)),
    ("bf16 GEMMs (cuBLAS nvjet)", ("nvjet", "bf16", "s16816gemm")),
    # fp32 GEMMs, or f64 ones on a float64 path
    ("GEMMs (cuBLAS, cutlass)", ("gemm", "sgemm", "xmma", "cutlass",
                                 "splitKreduce")),
    ("bf16 casts (hi/lo split)", ("bfloat16_copy", "BFloat16")),
    ("row gathers", ("index", "gather")),
    ("sort", ("sort", "radix", "Sort")),
    ("copies", ("copy", "Memcpy", "Memset", "fill", "cat")),
    ("elementwise", ("elementwise", "vectorized", "reduce", "Reduce")),
)


def _group(name: str) -> str:
    for label, keys in GROUPS:
        if any(k in name for k in keys):
            return label
    return "other"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scheme", default="flat",
                    choices=["crout", "flat", "recursive", "cholesky",
                             "swap", "split"])
    ap.add_argument("--pin-ab", action="store_true",
                    help="time the entry point against its unpinned body")
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "float64", "bfloat16"])
    args = ap.parse_args()
    dtype = getattr(torch, args.dtype)
    if not torch.cuda.is_available():
        raise SystemExit("torch_profile: needs a CUDA card")
    from conflux_tpu_torch.cholesky.single import cholesky
    from conflux_tpu_torch.lu.single import lu_factor
    from conflux_tpu_torch.timing import timed_run

    n = N
    g = torch.Generator(device="cuda").manual_seed(42)
    # float64 inputs are made in float64; bfloat16 ones are the float32
    # input rounded
    made = torch.float64 if dtype == torch.float64 else torch.float32
    if args.scheme == "cholesky":
        A = torch.rand(n, n, generator=g, device="cuda", dtype=made)
        A = A + A.T
        A.mul_(0.5)
        A.diagonal().add_(float(n))
        A = A.to(dtype)

        def run(fn=cholesky):
            return fn(A, V, PRECISION)
    else:
        A = (5.0 + torch.rand(n, n, generator=g, device="cuda",
                              dtype=made)).to(dtype)
        compact = args.scheme in ("swap", "split")
        scheme = "crout" if compact else args.scheme
        compaction = args.scheme if compact else "gather"

        def run(fn=lu_factor):
            return fn(A, V, PRECISION, scheme=scheme, compaction=compaction)

    run()
    torch.cuda.synchronize()
    if args.pin_ab:
        entry = cholesky if args.scheme == "cholesky" else lu_factor
        ab = {"pinned": [], "unpinned": []}
        for _ in range(REPS):
            for name in ("pinned", "unpinned", "unpinned", "pinned"):
                fn = entry if name == "pinned" else entry.__wrapped__
                ab[name].append(timed_run(run, fn)[0])
        print(f"{args.scheme}: walls with the IEEE fp32 pin "
              f"{[round(t, 3) for t in ab['pinned']]} ms (median "
              f"{statistics.median(ab['pinned']):.3f}), without "
              f"{[round(t, 3) for t in ab['unpinned']]} ms (median "
              f"{statistics.median(ab['unpinned']):.3f})")
    walls = [timed_run(run)[0] for _ in range(REPS)]
    wall = statistics.median(walls)
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    sums = defaultdict(float)
    counts = defaultdict(int)
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = ev.self_cuda_time_total
        label = _group(ev.key)
        sums[label] += us / 1e3
        counts[label] += ev.count
    busy = sum(sums.values())
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(f"{args.scheme} {args.dtype} N={n} v={V} '{PRECISION}' on {smi}: "
          f"unprofiled wall ms {[round(t, 3) for t in walls]} (median "
          f"{wall:.3f}), device busy {busy:.3f} ms in the profiled run, "
          f"idle share {1 - busy / wall:.3f} of the unprofiled "
          f"median, peak device memory {peak / 2 ** 30:.3f} GiB")
    for label, ms in sorted(sums.items(), key=lambda kv: -kv[1]):
        print(f"  {label:32s} {ms:10.3f} ms {counts[label]:8d} launches "
              f"{100 * ms / busy:6.1f} %")


if __name__ == "__main__":
    main()
