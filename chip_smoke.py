#!/usr/bin/env python3
"""Run the PyTorch port's main paths once on one CUDA card, and check them.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

  1. device: a CUDA card is required; print its name and power limit, the
     torch version, and assert that fp32 matrix products stay IEEE fp32;
  2. build: build (or load) every kernel from csrc/, one nvcc per source,
     started together: K1, the rank-1 panel kernel (rank1_panel.cu), and
     K1 in double (rank1_panel_f64.cu); the panel's pivot-triangle solve
     (panel_trsm.cu) and its pivot-lane gather and scatter
     (lane_move.cu); K3, the fused trailing update
     (schur_update.cu); K2, the big-K R - A@B (bigk_gemm.cu) with its
     bf16-operand entry (its kernels in wgmma_bf16.cuh), and K4, the
     plain GEMM (bigk_gemm.cu); K5 and K6, the row
     scatter and gather (row_move.cu);
  3. K1 vs plain: K1 against its plain PyTorch version on the same CUDA
     inputs, in unforced, forced and finish modes, at the main path's
     block shapes plus a ragged one with a masked lane, forced at the
     flat and Cholesky paths' [128, 1536] and [64, 1536] tile blocks with
     first pivots j0 > 0 (the tile route), and at the cluster route's
     widest block and 128 lanes more (the grid route) at w = 128 and 64
     in all three modes (forced ones on the tile route), and unforced at
     the recursive scheme's widest [64, 32768] block; every call
     checked against the route counter it must move; then K1 in double
     against the same plain version in f64 and cuSOLVER's f64 LU at the
     f64 crout path's [128, 32768] finish block and a [128, 17408] block
     (the grid route in double, its slab on chip), a [128, 2048] block
     (its cluster route) and the forced [128, 1536] pivot-row and
     [64, 1536] Cholesky tiles (its tile route), each call checked
     against the double route counter it must move; then the panel's
     pivot-triangle solve (panel_trsm.cu) against its plain version (the
     chain of 32-wide inverses and products it replaces) on the same CUDA
     inputs, in f32 and f64, at crout's block and group updates
     ([384, 128], [1024, 512]), Cholesky's block update ([448, 64]) and a
     ragged [100, 96], each call checked by its launch counter and timed
     beside the plain version and torch.linalg.solve_triangular (cuBLAS's
     trsm); then the panel's pivot-lane gather and scatter (lane_move.cu)
     against their plain versions, bit for bit, in f32 and f64 at crout's
     update shapes with m = 32768, each call checked by its launch counter
     and timed beside the one-hot product it replaces;
  4. K3 vs plain: the wgmma kernel's SASS must hold HGMMA, UTMALDG and
     SYNCS instructions; then K3 against its plain PyTorch version on the
     same CUDA inputs, in 'high', 'bf16' and 'bf16out', at the flat LU's
     first and a mid-run trailing update and at a ragged span, each call
     checked against its route counter (split pass + wgmma);
  5. K2 vs plain: the product kernel's SASS must hold HGMMA, UTMALDG and
     SYNCS instructions; then K2 against its plain version in the three
     modes at the crout path's panel updates (k = 1536, 15360, 30720), its
     pivot-row refreshes at k = 15360 and k = 30720 (the most heavily
     split call), the Cholesky path's panel update at k = 15360 (B a
     transposed view) and a ragged shape, with TFLOP/s; each call checked
     against its route counter (split pass + wgmma), R never written, a
     repeated call bit-identical; the split pass's time at the two largest
     calls beside the whole call's; then K2's bf16-operand entry against
     its plain version in 'bf16' and 'bf16out' at the bf16 crout and
     Cholesky paths' first and last panel updates (route, B's layout, no
     operand copied, a transposed B read in place, R unwritten, repeats
     bit-identical), timed beside torch.addmm, the one library call that
     computes R - A@B, and torch.mm(out_dtype=float32), the product
     alone;
  6. K4 vs plain: the wgmma kernel's SASS must hold HGMMA, UTMALDG and
     SYNCS instructions (cuobjdump); then K4 against its plain version at
     experiments/prof_pallas_gemm.py's shapes on each route, checked by
     its route counter: float32 operands (the FMA tile), bfloat16 ones
     (wgmma + TMA) and bfloat16 views with an odd row stride (mma.sync),
     with TFLOP/s beside torch.mm's and the bound;
  7. K5 and K6 vs plain, bit for bit: the swap compaction's [1536, 32768]
     push-up into a [32768, 32768] R, the gathers of that many rows and of
     the main path's compaction (31232 of 32768 rows), and the split
     path's narrow panel gather (31232 rows of T[:, 1536:3072]), each on
     the bulk-copy route, with GB/s;
  8. small end to end: crout ('gather', 'split', 'swap'), flat and
     recursive LU at N=2048 in 'high' and 'highest', Cholesky flat and
     recursive, and the two solves; then, with the caller's TF32 on
     (through the legacy knobs, then through `fp32_precision`), crout,
     flat, Cholesky and both solves at 'highest' give the same bits as
     with the defaults, and the caller's knobs read back as set;
  9. crout main path: lu_factor(A, v=1536, precision='high',
     scheme='crout') at N=32768 f32 (one warm-up, then timed runs), every
     kernel's launches per factorization, peak device memory, and the
     blocked residual; then the same with scheme='recursive' (its K1
     blocks held to its recursion, `rec_leaves`: 64-wide blocks of each
     leaf and of its pivot rows, no other kernel); then 'auto':
     lu_factor(A, v=1536, precision='high') with no scheme at N=32768,
     and at a smaller N on the other side of `auto_scheme`'s threshold
     where that lies within N, each launching exactly the kernels of the
     path auto_scheme names;
 10. flat path: the same with scheme='flat';
 11. Cholesky path: cholesky(A, v=1536, precision='high') at N=32768;
 12. swap and split paths: crout with compaction='swap' and 'split';
 13. dtypes: bf16 storage crout 'gather', flat and Cholesky, float64
     crout and Cholesky at N=32768 v=1536 (the main paths' inputs, rounded
     to bf16 or made in f64), and complex64 clu_factor at N=16384 (cut
     from 32768: its panel is the JAX package's per-column loop, eager,
     with no kernel in either package): each one warm-up and REPS timed
     runs, its launches per kernel and route held to DTYPE_PATHS (K1 in
     double's per route from the step loop through `route_f64`; the bf16
     crout's and Cholesky's calls of K2's bf16-operand entry per route,
     the Cholesky's all with B read K-major, through
     `sub_matmul_bigk_bf16_route`), its peak memory, and the JAX
     package's gate for that dtype;
 14. dist: the 2.5D rank programs, 8 ranks of one gloo world on this one
     card (kernels built in this process first, so the ranks only load
     them), in 'high' at N = 16384, v = 512 on a (2, 2, 2) grid: lu_25d
     at the auto variant ('windowed') and the left-looking 'crout', both
     tournament, and cholesky_25d at the auto variant ('crout'); the crout
     LU on a (1, 2, 4) grid (the fused panel) and the profiled LU
     (lu_25d_profiled) beside its unprofiled twin (lu_25d(unroll=False)),
     both at N = 8192 on (2, 2, 2); pdgetrf and pdpotrf at their default
     grid, tile and variant, 'highest', N = 8192; and at N = 8192,
     v = 256 on (2, 2, 2), lu_25d 'windowed' and 'crout' and cholesky_25d
     (auto variant) under bf16 storage and in float64, and at N = 4096
     complex64 clu_25d, each gated by the JAX package's bound for its
     dtype. Each run's launch counts
     are reset just before its factorization and read just after, K1's per
     route and K3's held on every rank to the counts derived from the step
     loops (`dist_k1_blocks`); each is gated on every rank by the SUMMA
     residual of its distributed blocks (`lu_residual_dist`,
     `cholesky_residual_dist`) before the gather, and that value held to
     1e-6 and to within 3x of the blocked residual of the gathered factor
     on grid rank 0; pdgetrf's ipiv replayed as swaps must give perm; the
     profiled LU's F and pivots must equal its twin's bit for bit, with
     the same launches, and its region table (five substeps, Nt calls
     each) is printed. Then `retile` from v = 512 to 1024 and back
     (bit-equal), and 'full' pivoting at N = 2048, v = 128, 'highest',
     whose pivots must equal the single-device lu_factor's. The walls are
     of 8 processes sharing one card with gloo moving every collective
     through host memory: not a multi-GPU time.
 15. stepped (between dtypes and dist): the stepped drivers, one run
     each, at N = 65536 (49152 where the host's memory cannot hold A and F
     in f32), v = 1024, 'high': lu_factor_stepped flat in f32 on the
     native-filled random_matrix with out='host' (the card's peak must
     stay within 1.3 copies of A) and in bf16 storage with out='device'
     (held to bf16 storage's ||PA - LU||_F / ||A||_F < 0.05),
     cholesky_stepped f32 on spd_matrix with out='host', and the crout
     stepped LU at N = 32768; each with its wall (upload and host stream
     included), device peak and launches held to its step loop
     (`_stepped_want`), gated by the streaming blocked gates on the card;
 16. cli (last): the front ends through their main(), as a user runs
     them: conflux_miniapp on the main path (-p 1x1x1, in this process,
     'high'; its launches held to three factorizations of the scheme
     auto_scheme names for the padded N) and on a
     (2, 2, 2) grid of 8 ranks it starts itself, cholesky_miniapp on
     (2, 2, 2), a profiled LU at N = 4096, the Cholesky helper's files
     with the port's float64 cholesky, and the sweep of
     configs/params_example.ini with its csv in a temporary directory;
     every `_result_` line checked field by field, every time > 0, every
     residual <= 1e-6.

Each kernel phase times the kernel, its plain version and, where one
PyTorch call computes the same function, that call (the kernel's
`library_ms`; the port never calls it), each as timing.per_call_ms: ten
calls back to back between two CUDA events, so the host's launch work
overlaps the device's; the median of five such runs, over ten. K4, K5
and K6 are timed against their library calls in turns. Each path's
launch counts are set to 0 just before it and read just after. The line
before the last but one is a JSON object with each kernel's numbers: its
`launches` are summed over the main paths (each one warm-up and REPS
timed factorizations), and `launches_by_path` gives each path's count;
K4, which no path runs (no path of the JAX package calls matmul_pallas),
counts the launches of its own phase. `launches_by_route` splits K1's
and K1 in double's into the cluster, grid and tile routes, K3's and K2's
into their one route
(split pass + wgmma), K4's by route and K5's and K6's into TMA bulk copies
and word copies; K1's per route are checked per path against counts
derived from the step loops. `bound_ms` is the least time the card could take for the kernel's
representative call, from this run's shapes. The line before the last is
the card's name and power limit; the last line is {"ok": true, "device":
{...}}.
"""

import json
import statistics
import subprocess
import sys
import time

import numpy as np

N, V = 32768, 1536
REPS = 3


def rec_leaves(m: int, n: int, v: int, k: int = 0):
    """(k, m, w) of every leaf of `lu.single._getrf_rec` on an [m, n]
    block whose first column is column k: its split n1 = max(v,
    (n // 2 // v) * v), the left [m, n1] half, then the [m - n1, n - n1]
    Schur complement."""
    if n <= v:
        return [(k, m, n)]
    n1 = max(v, (n // 2 // v) * v)
    return rec_leaves(m, n1, v, k) + rec_leaves(m - n1, n - n1, v, k + n1)


def k1_blocks(path: str, n: int = N, v: int = V):
    """(w, m, forced) of every K1 block of one n, v factorization of
    `path`, from its step loop: step k factors a panel of w = min(v, n - k)
    columns over the m = n - k live rows in 128-wide blocks (the stepped
    flat LU over all n rows: it never compacts); flat, swap and split
    (and the stepped flat) then refactor the w gathered pivot rows,
    forced, in [128, w] blocks; Cholesky factors each [w, w] diagonal
    tile, forced, in [64, w] blocks. The recursive scheme, from its
    recursion (`rec_leaves`): each [m, w] leaf selects its pivots in
    64-wide blocks (`ops.panel._BLOCK`), then refactors its w pivot rows,
    forced, in [64, w] blocks."""
    if path == "recursive":
        return [b for _, m, w in rec_leaves(n, n, v)
                for b in ([(min(64, w - c), m, False) for c in range(0, w, 64)]
                          + [(min(64, w - c), w, True)
                             for c in range(0, w, 64)])]
    blocks = []
    for k in range(0, n, v):
        w = min(v, n - k)
        if path.endswith("cholesky"):
            blocks += [(64, w, True)] * (w // 64)
            continue
        m = n if path == "stepped flat" else n - k
        blocks += [(128, m, False)] * (w // 128)
        if not path.endswith("crout"):
            blocks += [(128, w, True)] * (w // 128)
    return blocks


def lower_solve_launches(path: str, n: int = N, v: int = V) -> int:
    """csrc/lower_solve.cu's launches in one n, v factorization of `path`:
    crout's winners' solve (`lu.single._crout_steps`: crout, swap, split,
    the stepped crout, bf16 storage's crout, and the f64 crout where
    `ops.tri._LSOLVE_DTYPES` holds float64) launches it once per
    `ops.tri._LSOLVE_ROWS` rows of w at each step with k + w < n; no other
    path does."""
    import torch

    from conflux_tpu_torch.ops import tri

    if path not in ("crout", "swap", "split", "stepped crout",
                    "bf16 crout") and not (
            path == "f64 crout" and torch.float64 in tri._LSOLVE_DTYPES):
        return 0
    return sum(-(-v // tri._LSOLVE_ROWS) for k in range(0, n, v)
               if k + v < n)


def loop_launches(path: str, n: int = N, v: int = V) -> dict:
    """Each kernel's launches in one n, v factorization of `path` (a main
    path or a stepped one), from its step loop: K1's one per block of
    `k1_blocks`; K3's one per flat step with k + w < n; K2's one panel
    update per crout-family step with k > 0 (crout, swap, split and the
    stepped crout) plus one pivot-row refresh per step with k > 0 and
    k + w < n, and one panel update per Cholesky step with k > 0."""
    steps = -(-n // v)
    crout = path.endswith("crout") or path in ("swap", "split")
    return {"rank1_panel": len(k1_blocks(path, n, v)),
            "schur_update": steps - 1 if "flat" in path else 0,
            "sub_matmul_bigk": ((steps - 1) + (steps - 2) if crout
                                else steps - 1 if path.endswith("cholesky")
                                else 0)}


# at N=32768, v=1536: 22 steps, 21 panels of 1536 columns, one of 512
STEPS = -(-N // V)
# swap, per step: K6 gathers lu_top = M[piv] and Rpiv = R[piv]; where the
# kept prefix is not empty (every step but the last), K6 gathers the
# movers and K5 scatters them
K5_SWAP = STEPS - 1
K6_SWAP = 2 * STEPS + (STEPS - 1)
# split, per step: K6 gathers the panel T[origin, k:k+w] and lu_top; with
# k > 0, Lbuf[piv]; with k + w < n, T[origin[piv], k+w:]; where rows stay
# live (every step but the last), M[live_idx], and with k > 0 also
# Lbuf[live_idx]
K6_SPLIT = 2 * STEPS + (STEPS - 1) + (STEPS - 1) + (STEPS - 1) + (STEPS - 2)
KERNELS = ("rank1_panel", "schur_update", "sub_matmul_bigk", "matmul",
           "scatter_rows", "gather_rows", "rank1_panel_f64",
           "sub_matmul_bigk_bf16")
# launches per factorization of each path; a kernel left out runs 0 times
# (split and swap run each panel through factor_panel as flat does, and
# the big-K products of crout)
PATH_LAUNCHES = {p: loop_launches(p) for p in ("crout", "recursive", "flat",
                                               "cholesky", "swap", "split")}
PATH_LAUNCHES["swap"].update(scatter_rows=K5_SWAP, gather_rows=K6_SWAP)
PATH_LAUNCHES["split"]["gather_rows"] = K6_SPLIT
# the dtype paths of the dtypes phase, each with the path whose K1 blocks
# it runs: bf16 storage (K1 in f32 on the upcast panels; crout's big-K
# products on K2's bf16-operand entry, flat's trailing update K3 in
# 'bf16out'; crout keeps merged=True, so it refactors the pivot rows as
# flat does), float64 (K1 in double; every product an IEEE f64 torch.mm)
# and complex64 (no kernel in either package: the panel is an eager
# per-column loop, the products real torch.mm). Cholesky under bf16
# storage runs its panel updates on K2's bf16-operand entry too, B the
# transposed view F[k:k+w, :k].T read in place: over the path's 21 step
# shapes the entry beat the library's product and subtraction,
# col - schur_dot(L21, L1t, 'bf16'), that the path ran before
# (experiments/torch_kernel_ab.py --only k2bf16 --steps on the H100;
# cholesky/single.py).
_PL = PATH_LAUNCHES
DTYPE_PATHS = {
    "bf16 crout": ("flat", {
        "rank1_panel": _PL["flat"]["rank1_panel"],
        "sub_matmul_bigk_bf16": _PL["crout"]["sub_matmul_bigk"]}),
    "bf16 flat": ("flat", _PL["flat"]),
    "bf16 cholesky": ("cholesky", {
        "rank1_panel": _PL["cholesky"]["rank1_panel"],
        "sub_matmul_bigk_bf16": _PL["cholesky"]["sub_matmul_bigk"]}),
    "f64 crout": ("crout",
                  {"rank1_panel_f64": _PL["crout"]["rank1_panel"]}),
    "f64 cholesky": ("cholesky",
                     {"rank1_panel_f64": _PL["cholesky"]["rank1_panel"]}),
    "c64 clu": (None, {}),
}
# the complex LU runs at N cut to half: its panel is the JAX package's
# per-column loop, eager here, ~N * (v / 2) column steps per factorization
C64_N = N // 2
# the gates of the dtype paths (the JAX package's own bounds): bf16 LU
# ||PA - LU||_F / ||A||_F (tests/test_single_device.py:271-290, here
# times 1/N: the blocked gate's normalisation), bf16 Cholesky 2e-4
# (tests/test_cholesky_dist.py:217), f64 1e-14 (tests/test_f64_mode.py),
# c64 1e-6 (tests/test_complex.py:100)
DTYPE_GATES = {"bf16 crout": 0.05 / N, "bf16 flat": 0.05 / N,
               "bf16 cholesky": 2e-4, "f64 crout": 1e-14,
               "f64 cholesky": 1e-14, "c64 clu": 1e-6}


K1_ROUTES = ("cluster", "grid", "tile")
# K2's bf16-operand entry: its routes (cuda_gemm.sub_matmul_bigk_bf16_route)
# and its other counts, launches with B read transposed in place and
# operands copied first
BF16_ROUTES = ("tiles", "registers", "split-k", "cooperative")
BF16_COUNTS = BF16_ROUTES + ("k-major", "copies")


def bf16_entry_calls(path: str, n: int = N, v: int = V):
    """(m, n, k, B transposed) of every call of K2's bf16-operand entry in
    one n, v factorization of the bf16 `path`: crout's panel update [n - k,
    w] and pivot-row refresh [w, n - k - w] at each step with k > 0 (the
    refresh where k + w < n), Cholesky's panel update [n - k, w] with B
    the view F[k:k+w, :k].T."""
    calls = []
    for k in range(v, n, v):
        w = min(v, n - k)
        calls.append((n - k, w, k, path.endswith("cholesky")))
        if path.endswith("crout") and k + w < n:
            calls.append((w, n - k - w, k, False))
    return calls


def bf16_route_launches(route, path: str) -> dict:
    """The bf16 entry's counts per factorization of `path` (BF16_COUNTS),
    where route(m, n, k) names the route a call takes on this card."""
    calls = bf16_entry_calls(path)
    taken = [route(m, nn, k) for m, nn, k, _ in calls]
    out = {f"sub_matmul_bigk_bf16 {r}": taken.count(r) for r in BF16_ROUTES}
    out["sub_matmul_bigk_bf16 k-major"] = sum(bt for *_, bt in calls)
    out["sub_matmul_bigk_bf16 copies"] = 0
    return out


def k1_clustered(blocks, route, grid_cluster) -> int:
    """The blocks (w, m, forced) of `blocks` that take K1's grid route in
    clusters with the two-level exchange, where route(w, m, forced) names
    a block's route and grid_cluster(w, m) the grid route's cluster size
    (0: the flat exchange) on this card."""
    return sum(1 for b in blocks
               if route(*b) == "grid" and grid_cluster(b[0], b[1]) > 0)


def k1_route_launches(route, kernel: str = "rank1_panel",
                      grid_cluster=None) -> dict:
    """K1's (or, with kernel='rank1_panel_f64', K1 in double's) launches
    per factorization of each path on each route, where route(w, m,
    forced) names the route a block takes on this card; with
    grid_cluster (cuda_panel.grid_cluster), also the grid launches in
    clusters ('rank1_panel grid clustered')."""
    out = {}
    for path in PATH_LAUNCHES:
        blocks = k1_blocks(path)
        taken = [route(*b) for b in blocks]
        out[path] = {f"{kernel} {r}": taken.count(r) for r in K1_ROUTES}
        if grid_cluster is not None:
            out[path][f"{kernel} grid clustered"] = k1_clustered(
                blocks, route, grid_cluster)
    return out


# the card's published peaks (NVIDIA H100 SXM data sheet, dense) for the
# bound_ms of each kernel: device memory, bf16 tensor cores, fp32 FMA,
# fp64 outside the tensor cores (K1 in double does no matrix products)
HBM_BYTES_S = 3.35e12
BF16_FLOP_S = 989e12
FP32_FLOP_S = 67e12
FP64_FLOP_S = 34e12
RESIDUAL_GATE = 1e-6
# K1 applies the rank-1 updates in another order than its two-level plain
# version, so the two agree to a few fp32 roundings, not bit for bit
KERNEL_TOL = 1e-4          # of max|ref|
RAGGED = (128, 1000)
PANEL_SHAPES = ((128, 32768), (128, 17408), RAGGED)
MASKED_LANE = 500          # masked in the ragged shape
# forced blocks (w, m, j0) at the tile shapes of the paths that force the
# pivots j0..j0+w-1: flat's _pivot_factors ([128, 1536] blocks of the
# gathered pivot rows) and Cholesky's potrf_tile ([64, 1536] blocks);
# lanes below j0 are the earlier blocks' pivots, no longer available
FORCED_TILES = ((128, 1536, 128), (128, 1536, 1408), (64, 1536, 64),
                (64, 1536, 1472))
# K3 spans (m, ncols, k, c0, c1): the flat path's first trailing update,
# the one at step k = 15360, a ragged one, and the distributed LU's first
# (a rank's [Ml, Nl] = [8192, 8192] block, l = v / Pz = 256)
K3_SHAPES = (("first", 32768, 32768, 1536, 1536, 32768),
             ("mid", 17408, 32768, 1536, 16896, 32768),
             ("ragged", 1000, 1040, 200, 37, 1000),
             ("dist", 8192, 8192, 256, 0, 8192))
# 'high'/'bf16': kernel and plain version take the same bf16 operand
# values and differ only in fp32 summation order
K3_TOL = 1e-5              # of max(|A| @ |B|)
# K2 (tag, m, k, n, B transposed): R [m, n] - A [m, k] @ B [k, n] at the
# crout path's panel updates of steps k = 1536, 15360 and 30720, its
# pivot-row refreshes at k = 15360 and 30720, the Cholesky path's panel
# update at k = 15360 (B the view F[k:k+w, :k].T of an [N, N] F), and a
# ragged shape whose K is split across units
K2_SHAPES = (("panel k=1536", 31232, 1536, 1536, False),
             ("panel k=15360", 17408, 15360, 1536, False),
             ("panel k=30720", 2048, 30720, 1536, False),
             ("refresh k=15360", 1536, 15360, 15872, False),
             ("refresh k=30720", 1536, 30720, 512, False),
             ("Cholesky k=15360", 17408, 15360, 1536, True),
             ("ragged", 1000, 3001, 300, False))
# the calls whose split pass is timed beside the whole call ('high'): the
# largest A and the largest B of the crout path
K2_SPLIT_TIMED = ("panel k=15360", "refresh k=15360")
# K1 in double (w, m, mode, j0): the f64 crout path's first block (finish)
# and a mid panel's (the grid route, its slab on chip: the first's last
# rows in registers), a block of the last panels (the cluster route), a
# forced pivot-row tile and the f64 Cholesky's forced tile (the tile
# route), held to its plain version within a few f64 roundings of max|ref|
K1_F64_SHAPES = ((128, 32768, "finish", 0), (128, 17408, "unforced", 0),
                 (128, 2048, "unforced", 0), (128, 1536, "forced", 128),
                 (64, 1536, "forced", 64))
K1_F64_TOL = 1e-12
# the pivot-triangle solve (r, n, group): crout's block update at its
# widest, its group update, Cholesky's 64-wide block update at its widest,
# a ragged one
TRSM_SHAPES = ((384, 128, False), (1024, 512, True), (448, 64, False),
               (100, 96, False))
# crout's winners' solve [V, c] (ops/tri.solve_lower_rows, the diagonal
# kernel csrc/lower_solve.cu): c = N - k - V at the first, a middle and the
# last solve of the N = 32768 cells, the first and last of N = 16384's
WINNERS_COLS = (N - V, N // 2 + 1024, N % V, N // 2 - V, 1024)
# the panel's pivot-lane moves (rows, n) at crout's first panel, m = N
# lanes: a block update's gather of rows b0..g1 at its widest, a group
# update's gather of rows g0..w and its scatter into the 1024 rows past
# the group
LANE_SHAPES = ((512, 128), (1536, 512), (1024, 512))
# K2's bf16-operand entry (tag, m, k, n, B transposed): the bf16 crout
# path's first and last panel updates, and the bf16 Cholesky path's (B the
# transposed view F[k:k+w, :k].T, read in place)
K2_BF16_SHAPES = (("crout panel k=1536", N - V, V, V, False),
                  ("crout panel k=32256", N % V, N - N % V, N % V, False),
                  ("Cholesky k=1536", N - V, V, V, True),
                  ("Cholesky k=32256", N % V, N - N % V, N % V, True))
# K4 (m, k, n): experiments/prof_pallas_gemm.py's shapes; the gate is K3's
K4_SHAPES = ((16384, 512, 16384), (8192, 1024, 8192), (8192, 8192, 8192))
# K5/K6: swap's push-up of V rows into an [N, N] R, and the gathers of V
# rows and of the main path's first compaction (N - V of N rows)
ROW_MOVES = (("scatter", V), ("gather", V), ("gather", N - V))
# the split path's narrow panel gather T[origin, k:k+w] at k = V: rows of
# V f32 (6 KB) with row stride N
PANEL_SLICE = (V, 2 * V)
# the distributed phase: the 2.5D rank programs on a (2, 2, 2) grid of 8
# gloo ranks on this one card, at the reference configuration's N
# (BASELINE.md), v = 512 (l = v / Pz = 256: K3 runs every right-looking
# step); the crout LU also on a (1, 2, 4) grid (Px = 1: the fused panel),
# pdgetrf / pdpotrf at their default grid and tile, and the profiled LU,
# all three at N cut to DIST_N / 2 to keep the phase short; the retile
# round trip from v to 2v; and the 'full'-pivot parity check at
# (N, v) = DIST_CHECK
DIST_GRID = (2, 2, 2)
DIST_N, DIST_V = 16384, 512
DIST_CROUT_GRID = (1, 2, 4)
DIST_WINDOWS = 8              # lu_25d's default window count
DIST_CHECK = (2048, 128)
DIST_TIMEOUT = 600.0
# the distributed gates: each SUMMA residual within this factor of the
# residual of the gathered factor (tests/test_pgemm.py:38)
GATE_RATIO = 3.0
# K1 at the distributed paths' shapes (w, m, mode, j0): the local round
# over a rank's Ml = N / Px rows, the merge round over 2v candidates, the
# forced [v, v] tiles (the winners' refactor, Cholesky's potrf_tile), and
# the (1, 2, 4) crout's fused panel over its Ml = N / 2 rows
DIST_K1 = ((64, DIST_N // DIST_GRID[0], "unforced", 0),
           (64, 2 * DIST_V, "unforced", 0), (64, DIST_V, "forced", 64),
           (128, DIST_N // 2, "finish", 0))


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def _bound(flops: float, bytes_: float, flop_s: float):
    """(least ms, what bounds it): the larger of the bytes over the card's
    memory rate and the operations over its peak for their type."""
    t_bytes = bytes_ / HBM_BYTES_S * 1e3
    t_ops = flops / flop_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _in_turns(kernel, library, *args):
    """(kernel ms, library ms), each timed twice as per_call_ms in the
    order kernel, library, library, kernel, keeping the lesser of its two:
    the card's clock drifts under sustained load, and this order favours
    neither."""
    from conflux_tpu_torch.timing import per_call_ms

    t_k = per_call_ms(kernel, *args)
    t_l = per_call_ms(library, *args)
    t_l = min(t_l, per_call_ms(library, *args))
    return min(t_k, per_call_ms(kernel, *args)), t_l


def _cusolver_lu(A):
    """torch.linalg.lu_factor(A) through cuSOLVER (PyTorch's default picks
    MAGMA's batched routines for this shape), restored afterwards."""
    import torch

    torch.backends.cuda.preferred_linalg_library("cusolver")
    out = torch.linalg.lu_factor(A)
    torch.backends.cuda.preferred_linalg_library("default")
    return out


def _medium_precision(fn, *args, **kwargs):
    """fn(*args, **kwargs) under torch's fp32 matmul precision 'medium',
    restored to 'highest' afterwards (the setting is read when a product
    is launched)."""
    import torch

    torch.set_float32_matmul_precision("medium")
    out = fn(*args, **kwargs)
    torch.set_float32_matmul_precision("highest")
    return out


def phase_device():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    smi = smi.splitlines()[0]
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    print(f"device: {torch.cuda.get_device_name(0)} "
          f"x{torch.cuda.device_count()}")
    if torch.backends.cuda.matmul.allow_tf32:
        fail("torch.backends.cuda.matmul.allow_tf32 is True")
    if torch.get_float32_matmul_precision() != "highest":
        fail("fp32 matmul precision is "
             f"{torch.get_float32_matmul_precision()!r}, not 'highest'")
    return smi


SOURCES = ("rank1_panel", "schur_update", "bigk_gemm", "row_move",
           "rank1_panel_f64", "panel_trsm", "lane_move", "lower_solve")


def phase_build():
    from conflux_tpu_torch.ops import _build, cuda_gemm, cuda_lanes, \
        cuda_lower_solve, cuda_panel, cuda_scatter, cuda_trsm

    t0 = time.perf_counter()
    _build.build(SOURCES)
    cuda_panel._load()
    cuda_trsm._load()
    cuda_lower_solve._load()
    cuda_lanes._load()
    cuda_panel._load_f64()
    cuda_gemm._load()
    cuda_gemm._load_bigk()
    cuda_scatter._load()
    print(f"build: {', '.join(SOURCES)} built and loaded in "
          f"{time.perf_counter() - t0:.2f} s")
    for name in SOURCES:
        for line in _build.build_log(name).splitlines():
            if ("registers" in line or "Compiling entry" in line
                    or "spill" in line or "arning" in line):
                print(f"  {name}: " + line.strip())
    print(f"  schur_update: dynamic shared memory "
          f"{cuda_gemm._load().conflux_schur_update_smem_bytes()} bytes "
          f"per CTA ('high'), sub_matmul_bigk "
          f"{cuda_gemm._load_bigk().conflux_sub_matmul_bigk_smem_bytes()}, "
          f"its bf16-operand entry "
          f"{cuda_gemm._load_bigk().conflux_sub_matmul_bigk_bf16_smem_bytes()}"
          f" (rank1_panel: sized per call, up to the card's limit)")


def phase_k1():
    import torch

    from conflux_tpu_torch.ops import cuda_panel
    from conflux_tpu_torch.ops.panel import _rank1_block_t
    from conflux_tpu_torch.timing import per_call_ms

    # (w, m, mode, j0, seed)
    cases = [(w, m, mode, 0, 1000 * si + len(mode))
             for si, (w, m) in enumerate(PANEL_SHAPES)
             for mode in ("unforced", "forced", "finish")]
    cases += [(w, m, "forced", j0, 7000 + ti)
              for ti, (w, m, j0) in enumerate(FORCED_TILES)]
    # the cluster route's widest block and 128 lanes more (grid route) at
    # both block widths, in all three modes (forced with j0 = w)
    cases += [(w, cuda_panel.cluster_max_m(w) + past, mode,
               w if mode == "forced" else 0, 8000 + w + past + len(mode))
              for w in (128, 64) for past in (0, 128)
              for mode in ("unforced", "forced", "finish")]
    cases += [(w, m, mode, j0, 9000 + i)
              for i, (w, m, mode, j0) in enumerate(DIST_K1)]
    # the recursive scheme's widest pivot search: its first leaf's [64, N]
    # blocks (ops/panel.select_pivots, unforced)
    cases.append((64, N, "unforced", 0, 9500))
    counters = ("LAUNCHES", "LAUNCHES_CLUSTER", "LAUNCHES_GRID",
                "LAUNCHES_TILE", "LAUNCHES_GRID_CLUSTERED")
    rows = []
    for w, m, mode, j0, seed in cases:
        rng = np.random.default_rng(seed)
        A = rng.standard_normal((w, m)).astype(np.float32)
        forced, finish = mode == "forced", mode == "finish"
        if forced:
            # forced mode serves diagonally dominant tiles (no pivot
            # search): make the forced lanes j0..j0+w-1 so
            A[np.arange(w), j0 + np.arange(w)] += w
        avail = np.ones((1, m), np.float32)
        avail[0, :j0] = 0.0
        if (w, m) == RAGGED:
            avail[0, MASKED_LANE] = 0.0
        Mt = torch.from_numpy(A).cuda()
        av = torch.from_numpy(avail).cuda()

        def plain():
            return _rank1_block_t(Mt, av, j0, forced, finish)

        def kernel():
            return cuda_panel.rank1_block_t(Mt, av, forced, j0, finish)

        ref = plain()
        before = [getattr(cuda_panel, c) for c in counters]
        got = kernel()
        torch.cuda.synchronize()
        route = cuda_panel.route(w, m, forced)
        clustered = route == "grid" and cuda_panel.grid_cluster(w, m) > 0
        moved = tuple(getattr(cuda_panel, c) - b
                      for c, b in zip(counters, before))
        if moved != ((1,) + tuple(int(route == r) for r in K1_ROUTES)
                     + (int(clustered),)):
            fail(f"K1 [{w}, {m}] {mode}: route counters moved {moved}, "
                 f"expected the {route} route"
                 + (" in clusters" if clustered else ""))
        if clustered:
            route += f", clusters of {cuda_panel.grid_cluster(w, m)}"
        piv_ok = torch.equal(ref[2], got[2].long())
        ok_ok = torch.equal(ref[3], got[3] > 0)
        av_ok = torch.equal(ref[1], got[1])
        keep = torch.ones(m, dtype=torch.bool, device="cuda")
        if mode == "unforced":
            # pivot lanes are left stale by the plain two-level version
            # and finished by the kernel; no caller reads them
            keep[ref[2]] = False
        diff = float((ref[0] - got[0])[:, keep].abs().max())
        scale = float(ref[0][:, keep].abs().max())
        t_k = per_call_ms(kernel)
        t_p = per_call_ms(plain)
        # the library's LU with partial pivoting of the [m, w] block, every
        # lane available, through cuSOLVER; forced elimination has none
        t_l = None if forced else per_call_ms(_cusolver_lu, Mt.T)
        # each input read once and each output written once; w (w - 1) / 2
        # rank-1 multiply-adds per lane (2 operations each) and m w
        # divisions in fp32
        bound = _bound(1.0 * w * (w - 1) * m + w * m,
                       4.0 * (2 * w * m + 2 * m) + 8.0 * w, FP32_FLOP_S)
        tag = f"K1 [{w}, {m}] {mode} j0={j0} ({route} route)"
        lib = "none" if t_l is None else f"{t_l:.4f} ms"
        print(f"{tag}: pivots equal {piv_ok}, ok equal {ok_ok}, avail equal "
              f"{av_ok}, max|diff| {diff:.3e} (max|ref| {scale:.3e}, rel "
              f"{diff / scale:.3e}), kernel {t_k:.4f} ms, plain {t_p:.4f} "
              f"ms, torch.linalg.lu_factor (cuSOLVER) {lib}, bound "
              f"{bound[0]:.4f} ms "
              f"({bound[1]})")
        if not (piv_ok and ok_ok and av_ok):
            fail(f"{tag}: pivots/ok/avail disagree")
        if not diff <= KERNEL_TOL * scale:
            fail(f"{tag}: max|diff| {diff} > {KERNEL_TOL} * {scale}")
        rows.append({"shape": (w, m), "mode": mode, "j0": j0, "route": route,
                     "max_abs_err": diff, "ms": t_k, "plain_ms": t_p,
                     "library_ms": t_l, "bound_ms": bound[0],
                     "bound_by": bound[1]})
    return rows


def phase_trsm():
    """The pivot-triangle solve against its plain version on the same CUDA
    inputs, in f32 and f64: lu the merged factors of the pivot rows that
    partial pivoting picks from a random [2n, n] block (on the CPU), B
    random; within 2 eps kappa_inf(L) max|B| of the plain version (each
    side's forward error is of the order of eps kappa(L) max|B|)."""
    import torch

    from conflux_tpu_torch.ops import cuda_trsm
    from conflux_tpu_torch.ops.panel import _pivot_solve_plain, select_pivots
    from conflux_tpu_torch.timing import per_call_ms

    for r, n, group in TRSM_SHAPES:
        for dtype in (torch.float32, torch.float64):
            rng = np.random.default_rng(r + n)
            block = torch.from_numpy(rng.standard_normal((2 * n, n)))
            _, _, lu = select_pivots(block.to(dtype), torch.ones(
                2 * n, dtype=torch.bool), n, block=128)
            L64 = torch.tril(lu.double(), -1) + torch.eye(n,
                                                          dtype=torch.float64)
            kappa = float(L64.abs().sum(1).max()
                          * torch.linalg.inv(L64).abs().sum(1).max())
            lu = lu.T.contiguous().cuda().T          # column-major, as formed
            B = torch.from_numpy(rng.standard_normal((r, n))).to("cuda",
                                                                 dtype)
            before = cuda_trsm.LAUNCHES
            got = cuda_trsm.solve_unit_lower_t(B, lu)
            torch.cuda.synchronize()
            if cuda_trsm.LAUNCHES != before + 1:
                fail(f"panel_trsm [{r}, {n}]: launch counter moved "
                     f"{cuda_trsm.LAUNCHES - before}")
            ref = _pivot_solve_plain(B, lu, group)
            diff = float((got - ref).abs().max())
            scale = torch.finfo(dtype).eps * kappa * float(B.abs().max())
            L = L64.to("cuda", dtype)
            t_k = per_call_ms(cuda_trsm.solve_unit_lower_t, B, lu)
            t_p = per_call_ms(_pivot_solve_plain, B, lu, group)
            t_l = per_call_ms(lambda b: torch.linalg.solve_triangular(
                L.T, b, upper=True, left=False, unitriangular=True), B)
            size = torch.finfo(dtype).bits // 8
            # r n (n - 1) / 2 multiply-adds; B and X once, L's strict
            # lower part once
            bound = _bound(1.0 * r * n * (n - 1),
                           size * (2.0 * r * n + n * (n - 1) / 2),
                           FP64_FLOP_S if dtype == torch.float64
                           else FP32_FLOP_S)
            tag = f"panel_trsm [{r}, {n}] {str(dtype)[6:]}"
            print(f"{tag}: max|diff| {diff:.3e} (eps kappa max|B| "
                  f"{scale:.3e}, kappa {kappa:.3g}), kernel {t_k:.4f} ms, "
                  f"plain ({'group' if group else 'block'} chain) "
                  f"{t_p:.4f} ms, torch.linalg.solve_triangular "
                  f"{t_l:.4f} ms, bound {bound[0]:.4f} ms ({bound[1]})")
            if not diff <= 2 * scale:
                fail(f"{tag}: max|diff| {diff} > 2 * {scale}")


def phase_winners_solve():
    """Crout's winners' solve [V, c] at WINNERS_COLS, f32 and f64, on the
    winners' merged factors of a random [2V, V] block (partial pivoting,
    on the CPU), row-major as the step loop leaves them, B random: the
    blocked solve with the diagonal kernel (`ops/tri.solve_lower_rows`
    with `cuda_lower_solve.solve_diag`, IEEE fp32 products) within 2 eps
    kappa_inf(L) max|B| of its plain version (`solve_lower_rows` with
    `_diag_solve_plain`) and of the float64 solve, its kernel launches
    checked by the counter; timed beside its bound, the plain version, the
    inverse chain it replaced (`_solve_unit_lower_blocked`) and
    `torch.linalg.solve_triangular` (a yardstick only: no path calls it).
    Crout takes the blocked solve in the dtypes of `tri._LSOLVE_DTYPES`
    (float32); float64 is timed all the same."""
    import torch

    from conflux_tpu_torch.ops import cuda_lower_solve, tri
    from conflux_tpu_torch.ops.panel import select_pivots
    from conflux_tpu_torch.precision import ieee_fp32
    from conflux_tpu_torch.timing import per_call_ms

    @ieee_fp32()
    def blocked(lu, B, X):
        tri.solve_lower_rows(lu, B, X, cuda_lower_solve.solve_diag)

    for dtype in (torch.float32, torch.float64):
        rng = np.random.default_rng(V)
        block = torch.from_numpy(rng.standard_normal((2 * V, V)))
        _, _, lu = select_pivots(block.to(dtype), torch.ones(
            2 * V, dtype=torch.bool), V, block=128)
        L64 = torch.tril(lu.double(), -1) + torch.eye(V, dtype=torch.float64)
        kappa = float(L64.abs().sum(1).max()
                      * torch.linalg.inv(L64).abs().sum(1).max())
        lu = lu.contiguous().cuda()
        L64 = L64.cuda()
        L = L64.to(dtype)
        for c in WINNERS_COLS:
            B = torch.from_numpy(rng.standard_normal((V, c))).to("cuda",
                                                                 dtype)
            X, Bw = torch.empty_like(B), B.clone()
            before = cuda_lower_solve.LAUNCHES
            blocked(lu, Bw, X)
            torch.cuda.synchronize()
            blocks = -(-V // tri._LSOLVE_ROWS)
            if cuda_lower_solve.LAUNCHES != before + blocks:
                fail(f"winners' solve [{V}, {c}]: launch counter moved "
                     f"{cuda_lower_solve.LAUNCHES - before}, not {blocks}")
            plain = torch.empty_like(B)
            tri.solve_lower_rows(lu, B.clone(), plain)
            ref = torch.linalg.solve_triangular(L64, B.double(), upper=False,
                                                unitriangular=True)
            diff = float((X - plain).abs().max())
            diff64 = float((X.double() - ref).abs().max())
            scale = torch.finfo(dtype).eps * kappa * float(B.abs().max())
            t_k = per_call_ms(blocked, lu, Bw, X)
            t_p = per_call_ms(tri.solve_lower_rows, lu, Bw, plain, calls=2,
                              reps=1)
            t_c = per_call_ms(lambda b: tri._solve_unit_lower_blocked(
                tri.unit_lower(lu), b), B)
            t_l = per_call_ms(lambda b: torch.linalg.solve_triangular(
                L, b, upper=False, unitriangular=True), B)
            size = torch.finfo(dtype).bits // 8
            # V (V - 1) / 2 c multiply-adds at the fp32 FMA rate (the f64
            # products' tensor cores run at it too); B and X once, L's
            # strict lower part once
            bound = _bound(1.0 * V * (V - 1) * c,
                           size * (2.0 * V * c + V * (V - 1) / 2),
                           FP32_FLOP_S)
            tag = f"winners' solve [{V}, {c}] {str(dtype)[6:]}"
            print(f"{tag}: max|diff| {diff:.3e} against the plain version, "
                  f"{diff64:.3e} against float64 (eps kappa max|B| "
                  f"{scale:.3e}, kappa {kappa:.3g}), blocked solve "
                  f"{t_k:.4f} ms ({blocks} kernel launches), bound "
                  f"{bound[0]:.4f} ms ({bound[1]}), plain version "
                  f"{t_p:.4f} ms, inverse chain {t_c:.4f} ms, "
                  f"torch.linalg.solve_triangular {t_l:.4f} ms")
            if not (diff <= 2 * scale and diff64 <= 2 * scale):
                fail(f"{tag}: max|diff| {diff}, {diff64} > 2 * {scale}")
            del B, X, Bw, plain, ref


def phase_lanes():
    """The panel's pivot-lane gather and scatter against their plain
    versions on copies of the same inputs, bit for bit, in f32 and f64, at
    LANE_SHAPES with m = N lanes, a third of the entries not ok (their
    lanes repeating ok ones); each call checked by its launch counter and
    timed beside the one-hot product it replaces."""
    import torch

    from conflux_tpu_torch.ops import cuda_lanes
    from conflux_tpu_torch.ops.panel import _gather_lanes, _scatter_lanes
    from conflux_tpu_torch.timing import per_call_ms

    for rows, n in LANE_SHAPES:
        for dtype in (torch.float32, torch.float64):
            rng = np.random.default_rng(rows + n)
            T = torch.from_numpy(rng.standard_normal((rows, N))).to("cuda",
                                                                    dtype)
            lanes = rng.permutation(N)[:n]
            ok = np.arange(n) < 2 * n // 3
            lanes[~ok] = lanes[rng.integers(0, n, int((~ok).sum()))]
            piv = torch.from_numpy(lanes).cuda()
            okc = torch.from_numpy(ok).cuda()
            vals = torch.from_numpy(rng.standard_normal((rows, n))).to(
                "cuda", dtype)
            before = (cuda_lanes.GATHER_LAUNCHES, cuda_lanes.SCATTER_LAUNCHES)
            got = _gather_lanes(T, piv, okc)
            dst = T.clone()
            _scatter_lanes(dst, piv, okc, vals)
            torch.cuda.synchronize()
            moved = (cuda_lanes.GATHER_LAUNCHES - before[0],
                     cuda_lanes.SCATTER_LAUNCHES - before[1])
            tag = f"lane moves [{rows}, {n}] of m = {N} {str(dtype)[6:]}"
            if moved != (1, 1):
                fail(f"{tag}: launch counters moved {moved}")
            Tc, pc, oc = T.cpu(), piv.cpu(), okc.cpu()
            want = Tc.clone()
            _scatter_lanes(want, pc, oc, vals.cpu())
            if not (torch.equal(got.cpu(), _gather_lanes(Tc, pc, oc))
                    and torch.equal(dst.cpu(), want)):
                fail(f"{tag}: the kernels differ from the plain versions")
            onehot = ((torch.arange(N, device="cuda")[None, :] == piv[:, None])
                      & okc[:, None]).to(dtype)
            t_g = per_call_ms(cuda_lanes.gather_lanes, T, piv, okc)
            t_s = per_call_ms(cuda_lanes.scatter_lanes_, dst, piv, okc, vals)
            t_o = per_call_ms(torch.mm, T, onehot.T)
            size = torch.finfo(dtype).bits // 8
            bound = _bound(0.0, size * 2.0 * rows * n, 1.0)
            print(f"{tag}: bit-equal to the plain versions, gather "
                  f"{t_g:.4f} ms, scatter {t_s:.4f} ms (per call, the "
                  f"wrapper's host work included), one-hot product "
                  f"T @ onehot.T {t_o:.4f} ms, bound {bound[0]:.4f} ms "
                  f"({bound[1]})")


def phase_k1_f64():
    """K1 in double against its plain version (the same `_rank1_block_t`,
    in f64) and against cuSOLVER's f64 LU of the same block, each call
    checked against the double route counter it must move."""
    import torch

    from conflux_tpu_torch.ops import cuda_panel
    from conflux_tpu_torch.ops.panel import _rank1_block_t
    from conflux_tpu_torch.timing import per_call_ms

    rows = []
    for i, (w, m, mode, j0) in enumerate(K1_F64_SHAPES):
        rng = np.random.default_rng(9500 + i)
        A = rng.standard_normal((w, m))
        forced, finish = mode == "forced", mode == "finish"
        if forced:
            A[np.arange(w), j0 + np.arange(w)] += w
        avail = np.ones((1, m))
        avail[0, :j0] = 0.0
        Mt = torch.from_numpy(A).cuda()
        av = torch.from_numpy(avail).cuda()

        def plain():
            return _rank1_block_t(Mt, av, j0, forced, finish)

        def kernel():
            return cuda_panel.rank1_block_t_f64(Mt, av, forced, j0, finish)

        ref = plain()
        counters = ("LAUNCHES", "LAUNCHES_F64", "LAUNCHES_F64_CLUSTER",
                    "LAUNCHES_F64_GRID", "LAUNCHES_F64_TILE")
        before = [getattr(cuda_panel, c) for c in counters]
        got = kernel()
        torch.cuda.synchronize()
        route = cuda_panel.route_f64(w, m, forced)
        moved = tuple(getattr(cuda_panel, c) - b
                      for c, b in zip(counters, before))
        if moved != (0, 1) + tuple(int(route == r) for r in K1_ROUTES):
            fail(f"K1 f64 [{w}, {m}] {mode}: counters moved {moved}, "
                 f"expected the {route} route in double")
        piv_ok = torch.equal(ref[2], got[2].long())
        ok_ok = torch.equal(ref[3], got[3] > 0)
        av_ok = torch.equal(ref[1], got[1])
        keep = torch.ones(m, dtype=torch.bool, device="cuda")
        if mode == "unforced":
            keep[ref[2]] = False      # stale in the plain version, unread
        diff = float((ref[0] - got[0])[:, keep].abs().max())
        scale = float(ref[0][:, keep].abs().max())
        t_k = per_call_ms(kernel)
        t_p = per_call_ms(plain)
        t_l = None if forced else per_call_ms(_cusolver_lu, Mt.T)
        bound = _bound(1.0 * w * (w - 1) * m + w * m,
                       8.0 * (2 * w * m + 2 * m) + 8.0 * w, FP64_FLOP_S)
        tag = f"K1 f64 [{w}, {m}] {mode} j0={j0} ({route} route in double)"
        lib = "none" if t_l is None else f"{t_l:.4f} ms"
        print(f"{tag}: pivots equal {piv_ok}, ok equal {ok_ok}, avail equal "
              f"{av_ok}, max|diff| {diff:.3e} (rel {diff / scale:.3e}), "
              f"kernel {t_k:.4f} ms, plain {t_p:.4f} ms, "
              f"torch.linalg.lu_factor f64 (cuSOLVER) {lib}, bound "
              f"{bound[0]:.4f} ms ({bound[1]})")
        if not (piv_ok and ok_ok and av_ok):
            fail(f"{tag}: pivots/ok/avail disagree")
        if not diff <= K1_F64_TOL * scale:
            fail(f"{tag}: max|diff| {diff} > {K1_F64_TOL} * {scale}")
        rows.append({"shape": (w, m), "mode": mode, "route": route,
                     "max_abs_err": diff, "ms": t_k, "plain_ms": t_p,
                     "library_ms": t_l, "bound_ms": bound[0],
                     "bound_by": bound[1]})
        del Mt, av, ref, got
    return rows


def _full_bf16_reduction(fn):
    """fn(R, A, B, alpha=-1) with cuBLAS's bf16 reduced-precision
    reduction off, the caller's setting given back afterwards."""
    import torch

    def call(R, A, B):
        knob = torch.backends.cuda.matmul
        before = knob.allow_bf16_reduced_precision_reduction
        knob.allow_bf16_reduced_precision_reduction = False
        try:
            return fn(R, A, B, alpha=-1)
        finally:
            knob.allow_bf16_reduced_precision_reduction = before
    return call


def _addmm_bf16(mode: str):
    """(fn(R, A, B), label): the one PyTorch call that computes R - A @ B
    on bf16 operands in `mode`: torch.addmm(R, A, B, out_dtype=float32,
    alpha=-1) for 'bf16' (aten::addmm.dtype), torch.addmm(R_bf16, A, B,
    alpha=-1) for 'bf16out' with bf16 reduced-precision reduction off
    (cuBLAS could otherwise sum split-K partials in bf16, another
    function). Where this torch refuses the out_dtype overload, the
    'bf16' yardstick is R - torch.mm(A, B, out_dtype=float32), labelled as
    two calls. Neither is used anywhere in the port."""
    import torch

    if mode == "bf16out":
        return (_full_bf16_reduction(torch.addmm),
                "torch.addmm(R_bf16, A, B, alpha=-1)")
    try:
        a = torch.ones(8, 8, dtype=torch.bfloat16, device="cuda")
        torch.addmm(torch.zeros(8, 8, device="cuda"), a, a,
                    out_dtype=torch.float32, alpha=-1)
    except (TypeError, RuntimeError, NotImplementedError) as e:
        print(f"torch.addmm refuses out_dtype=float32 on bf16 operands "
              f"({type(e).__name__}): the 'bf16' yardstick is two calls")
        return (lambda R, A, B: R - torch.mm(A, B, out_dtype=torch.float32),
                "R - torch.mm(A, B, out_dtype=float32), two calls")
    return (lambda R, A, B: torch.addmm(R, A, B, out_dtype=torch.float32,
                                        alpha=-1),
            "torch.addmm(R, A, B, out_dtype=float32, alpha=-1)")


def phase_k2_bf16():
    """K2's bf16-operand entry against its plain version (R - schur_dot(A,
    B, 'bf16'), rounded once into R's type), in 'bf16' and 'bf16out', at
    K2_BF16_SHAPES; timed beside the one library call that computes the
    same R - A @ B (`_addmm_bf16`) and, for continuity, the library's
    product alone, torch.mm(A, B, out_dtype=float32). A transposed B must
    be read in place (K-major, no copy)."""
    import torch

    from conflux_tpu_torch.ops import cuda_gemm
    from conflux_tpu_torch.ops.gemm import _sub_matmul_bigk_t
    from conflux_tpu_torch.timing import per_call_ms

    rows = []
    for si, (tag, m, k, n, bt) in enumerate(K2_BF16_SHAPES):
        g = torch.Generator(device="cuda").manual_seed(950 + si)
        A = torch.randn(m, k, generator=g, device="cuda").to(torch.bfloat16)
        B = (torch.randn(n, k, generator=g, device="cuda")
             .to(torch.bfloat16).T if bt else
             torch.randn(k, n, generator=g, device="cuda")
             .to(torch.bfloat16))
        R32 = torch.randn(m, n, generator=g, device="cuda")
        scale = float(torch.mm(A.float().abs(), B.float().abs()).max())
        t_mm = per_call_ms(lambda: torch.mm(A, B, out_dtype=torch.float32))
        for mode in ("bf16", "bf16out"):
            R = R32.to(torch.bfloat16) if mode == "bf16out" else R32
            R0 = R.clone()
            ref = _sub_matmul_bigk_t(R, A, B, mode)
            before = (cuda_gemm.SUB_MATMUL_BIGK_LAUNCHES,
                      cuda_gemm.SUB_MATMUL_BIGK_BF16_LAUNCHES)
            got = cuda_gemm.sub_matmul_bigk_bf16(R, A, B, mode)
            torch.cuda.synchronize()
            last = dict(cuda_gemm.BF16_LAST)
            moved = (cuda_gemm.SUB_MATMUL_BIGK_LAUNCHES - before[0],
                     cuda_gemm.SUB_MATMUL_BIGK_BF16_LAUNCHES - before[1])
            if moved != (0, 1):
                fail(f"K2 bf16 {tag} {mode}: counters moved {moved}")
            if last["copied"]:
                fail(f"K2 bf16 {tag} {mode}: operands {last['copied']} "
                     "were copied first")
            if last["b_layout"] != ("k-major" if bt else "mn-major"):
                fail(f"K2 bf16 {tag} {mode}: B read {last['b_layout']}")
            if not torch.equal(R, R0):
                fail(f"K2 bf16 {tag} {mode}: R was written")
            if not torch.equal(got, cuda_gemm.sub_matmul_bigk_bf16(R, A, B,
                                                                   mode)):
                fail(f"K2 bf16 {tag} {mode}: a repeated call gave other "
                     "bits")
            d = (got.float() - ref.float()).abs()
            diff = float(d.max())
            if mode == "bf16out":
                bad = int((d > _bf16_ulp(ref) + K3_TOL * scale).sum())
                check = f"{bad} over 1 bf16 ulp + {K3_TOL:.0e} * max(|A|@|B|)"
                good = bad == 0
            else:
                check = (f"rel to max(|A|@|B|) {diff / scale:.3e} (gate "
                         f"{K3_TOL:.0e})")
                good = diff <= K3_TOL * scale
            del d
            if not good:
                fail(f"K2 bf16 {tag} {mode}: kernel and plain disagree "
                     f"({check})")
            library, label = _addmm_bf16(mode)
            t_k, t_l = _in_turns(
                lambda: cuda_gemm.sub_matmul_bigk_bf16(R, A, B, mode),
                lambda: library(R, A, B))
            t_p = per_call_ms(_sub_matmul_bigk_t, R, A, B, mode)
            bound = _bound(2.0 * m * n * k,
                           2.0 * R.element_size() * m * n
                           + 2.0 * (m * k + k * n), BF16_FLOP_S)
            tflops = 2.0 * m * n * k / (t_k * 1e-3) / 1e12
            print(f"K2 bf16 operands {tag} R [{m}, {n}] k {k} {mode:7s}: "
                  f"route {last['route']}, B {last['b_layout']}"
                  f"{' (transposed, read in place)' if bt else ''}, max|diff| "
                  f"{diff:.3e}, {check}, repeat bit-identical, R unwritten, "
                  f"kernel {t_k:.4f} ms ({tflops:.1f} TFLOP/s), {label} "
                  f"{t_l:.4f} ms, torch.mm(out_dtype=float32) {t_mm:.4f} ms "
                  f"(the product alone), plain {t_p:.4f} ms, bound "
                  f"{bound[0]:.4f} ms ({bound[1]})")
            rows.append({"shape": tag, "mode": mode, "max_abs_err": diff,
                         "ms": t_k, "plain_ms": t_p, "library_ms": t_l,
                         "library_call": label, "mm_ms": t_mm,
                         "bound_ms": bound[0], "bound_by": bound[1],
                         "route": last["route"],
                         "b_layout": last["b_layout"]})
            del ref, got, R, R0
        del A, B, R32
        torch.cuda.empty_cache()
    return rows


def _bf16_ulp(x):
    """Spacing of bfloat16 numbers at each element of x (8 significant
    bits; the smallest subnormal at 0)."""
    import torch

    _, e = torch.frexp(x.float())
    ulp = torch.ldexp(torch.ones_like(x, dtype=torch.float32), e - 8)
    return torch.where(x == 0, 2.0 ** -133, ulp)


def phase_medium_probe() -> bool:
    """Does this torch run an fp32 product under matmul precision 'medium'
    as one bf16 pass (the 'bf16' mode of K2 and K3)? Only then is addmm
    under 'medium' their library call."""
    import torch

    from conflux_tpu_torch.ops.tri import schur_dot

    g = torch.Generator(device="cuda").manual_seed(77)
    A = torch.randn(2048, 2048, generator=g, device="cuda")
    B = torch.randn(2048, 2048, generator=g, device="cuda")
    got = _medium_precision(torch.mm, A, B)
    diff = float((got - schur_dot(A, B, "bf16")).abs().max())
    scale = float(torch.mm(A.abs(), B.abs()).max())
    ok = diff <= K3_TOL * scale
    print(f"fp32 matmul precision 'medium' against one bf16 pass: max|diff| "
          f"{diff / scale:.3e} of max(|A|@|B|) (gate {K3_TOL:.0e}): "
          + ("bf16, so addmm under 'medium' is the 'bf16' library call" if ok
             else "not bf16 (TF32 keeps more bits), so 'bf16' has no "
             "library call"))
    if torch.get_float32_matmul_precision() != "highest":
        fail("fp32 matmul precision not restored to 'highest'")
    return ok


def _library_sub(mode: str, medium_bf16: bool):
    """The one PyTorch call that computes R - A @ B in `mode`, or None:
    addmm under 'medium' for 'bf16' where that is one bf16 pass; 'high'
    (three bf16 passes) and 'bf16out' (the result rounded into a bf16 R)
    have none."""
    import torch

    if mode != "bf16" or not medium_bf16:
        return None
    return lambda R, A, B: _medium_precision(torch.addmm, R, A, B,
                                             beta=1, alpha=-1)


def phase_k3(medium_bf16: bool):
    import torch

    from conflux_tpu_torch.ops import cuda_gemm
    from conflux_tpu_torch.ops.gemm import MODES, _schur_update_t
    from conflux_tpu_torch.timing import per_call_ms

    # every template instance of the product (three modes) holds wgmma
    _sass_check([("schur_update", "schur_update_wgmma_kernel",
                  ("HGMMA", "UTMALDG", "SYNCS"), True)])
    counters = ("SCHUR_UPDATE_LAUNCHES", "SCHUR_UPDATE_WGMMA_LAUNCHES")
    rows = []
    for si, (tag, m, ncols, k, c0, c1) in enumerate(K3_SHAPES):
        g = torch.Generator(device="cuda").manual_seed(500 + si)
        A = torch.randn(m, k, generator=g, device="cuda")
        B = torch.randn(k, c1 - c0, generator=g, device="cuda")
        R32 = torch.randn(m, ncols, generator=g, device="cuda")
        scale = float(torch.mm(A.abs(), B.abs()).max())
        for mode in ("high", "bf16", "bf16out"):
            R0 = R32.to(torch.bfloat16) if mode == "bf16out" else R32
            ref = _schur_update_t(R0.clone(), A, B, c0, mode, c1)
            before = [getattr(cuda_gemm, c) for c in counters]
            got = cuda_gemm.schur_update(R0.clone(), A, B, c0, mode, c1)
            torch.cuda.synchronize()
            moved = tuple(getattr(cuda_gemm, c) - b
                          for c, b in zip(counters, before))
            if moved != (1, 1):
                fail(f"K3 {tag} {mode}: route counters moved {moved}, "
                     "expected the wgmma route")
            outside = (torch.equal(got[:, :c0], R0[:, :c0])
                       and torch.equal(got[:, c1:], R0[:, c1:]))
            d = (got[:, c0:c1].float() - ref[:, c0:c1].float()).abs()
            diff = float(d.max())
            if mode == "bf16out":
                # both are roundings of fp32 values that may differ by the
                # summation tolerance; where R - A@B nearly cancels, that
                # exceeds the tiny bf16 ulp of the result, so the gate is
                # one ulp plus that tolerance
                ulp = _bf16_ulp(ref[:, c0:c1])
                ulps = d / ulp
                over = int((ulps > 1).sum())
                bad = int((d > ulp + K3_TOL * scale).sum())
                check = (f"max {float(ulps.max()):.3f} bf16 ulp, {over} "
                         f"elements over 1 ulp, {bad} over 1 ulp + "
                         f"{K3_TOL:.0e} * max(|A|@|B|)")
                good = bad == 0
            else:
                check = (f"rel to max(|A|@|B|) {diff / scale:.3e} "
                         f"(gate {K3_TOL:.0e})")
                good = diff <= K3_TOL * scale
            del d
            t_k = per_call_ms(cuda_gemm.schur_update, got, A, B, c0, mode, c1)
            t_p = per_call_ms(_schur_update_t, ref, A, B, c0, mode, c1)
            lib = _library_sub(mode, medium_bf16)
            t_l = (None if lib is None else
                   per_call_ms(lib, R0[:, c0:c1], A, B))
            nt = c1 - c0
            esize = R0.element_size()
            bound = _bound(MODES[mode][1] * 2.0 * m * nt * k,
                           2.0 * esize * m * nt + 4.0 * (m * k + k * nt),
                           BF16_FLOP_S)
            tflops = 2.0 * m * nt * k / (t_k * 1e-3) / 1e12
            libs = "none" if t_l is None else f"{t_l:.4f} ms"
            print(f"K3 {tag} R [{m}, {ncols}] k {k} span [{c0}, {c1}) "
                  f"{mode:7s}: max|diff| {diff:.3e}, {check}, outside span "
                  f"unchanged {outside}, kernel {t_k:.4f} ms "
                  f"({tflops:.1f} TFLOP/s of A@B), plain {t_p:.4f} ms, "
                  f"library {libs}, bound {bound[0]:.4f} ms ({bound[1]})")
            if not outside:
                fail(f"K3 {tag} {mode}: columns outside [{c0}, {c1}) changed")
            if not good:
                fail(f"K3 {tag} {mode}: kernel and plain disagree ({check})")
            rows.append({"shape": tag, "mode": mode, "max_abs_err": diff,
                         "ms": t_k, "plain_ms": t_p, "library_ms": t_l,
                         "bound_ms": bound[0], "bound_by": bound[1]})
            del ref, got
        del A, B, R32
        torch.cuda.empty_cache()
    return rows


def phase_k2(medium_bf16: bool):
    import torch

    from conflux_tpu_torch.ops import cuda_gemm
    from conflux_tpu_torch.ops.gemm import MODES, _sub_matmul_bigk_t
    from conflux_tpu_torch.timing import per_call_ms

    # every template instance of the product (three modes) holds wgmma;
    # K4's mma.sync kernel shares the library, so the check is per function
    _sass_check([("bigk_gemm", "sub_matmul_bigk_kernel",
                  ("HGMMA", "UTMALDG", "SYNCS"), True)])
    counters = ("SUB_MATMUL_BIGK_LAUNCHES", "SUB_MATMUL_BIGK_WGMMA_LAUNCHES")
    rows = []
    for si, (tag, m, k, n, bt) in enumerate(K2_SHAPES):
        g = torch.Generator(device="cuda").manual_seed(900 + si)
        A = torch.randn(m, k, generator=g, device="cuda")
        B = (torch.randn(n, N, generator=g, device="cuda")[:, :k].T if bt
             else torch.randn(k, n, generator=g, device="cuda"))
        R32 = torch.randn(m, n, generator=g, device="cuda")
        scale = float(torch.mm(A.abs(), B.abs()).max())
        splits = cuda_gemm.sub_matmul_bigk_splits(m, n, k)
        for mode in ("high", "bf16", "bf16out"):
            R = R32.to(torch.bfloat16) if mode == "bf16out" else R32
            R0 = R.clone()
            ref = _sub_matmul_bigk_t(R, A, B, mode)
            before = [getattr(cuda_gemm, c) for c in counters]
            got = cuda_gemm.sub_matmul_bigk(R, A, B, mode)
            torch.cuda.synchronize()
            moved = tuple(getattr(cuda_gemm, c) - b
                          for c, b in zip(counters, before))
            if moved != (1, 1):
                fail(f"K2 {tag} {mode}: route counters moved {moved}, "
                     "expected the wgmma route")
            if not torch.equal(R, R0):
                fail(f"K2 {tag} {mode}: R was written")
            if not torch.equal(got, cuda_gemm.sub_matmul_bigk(R, A, B,
                                                              mode)):
                fail(f"K2 {tag} {mode}: a repeated call gave other bits")
            d = (got.float() - ref.float()).abs()
            diff = float(d.max())
            if mode == "bf16out":
                ulp = _bf16_ulp(ref)
                bad = int((d > ulp + K3_TOL * scale).sum())
                check = (f"max {float((d / ulp).max()):.3f} bf16 ulp, {bad} "
                         f"over 1 ulp + {K3_TOL:.0e} * max(|A|@|B|)")
                good = bad == 0
            else:
                check = (f"rel to max(|A|@|B|) {diff / scale:.3e} "
                         f"(gate {K3_TOL:.0e})")
                good = diff <= K3_TOL * scale
            del d
            t_k = per_call_ms(cuda_gemm.sub_matmul_bigk, R, A, B, mode)
            t_p = per_call_ms(_sub_matmul_bigk_t, R, A, B, mode)
            lib = _library_sub(mode, medium_bf16)
            t_l = None if lib is None else per_call_ms(lib, R, A, B)
            bound = _bound(MODES[mode][1] * 2.0 * m * n * k,
                           2.0 * R.element_size() * m * n
                           + 4.0 * (m * k + k * n), BF16_FLOP_S)
            tflops = 2.0 * m * n * k / (t_k * 1e-3) / 1e12
            libs = "none" if t_l is None else f"{t_l:.4f} ms"
            print(f"K2 {tag} R [{m}, {n}] k {k} ({splits} K splits) "
                  f"{mode:7s}: max|diff| {diff:.3e}, {check}, repeat "
                  f"bit-identical, kernel {t_k:.4f} ms ({tflops:.1f} "
                  f"TFLOP/s of A@B), plain {t_p:.4f} ms, library {libs}, "
                  f"bound {bound[0]:.4f} ms ({bound[1]})")
            if mode == "high" and tag in K2_SPLIT_TIMED:
                # the same split pass the call runs first, alone, on both
                # operands (hi and lo)
                t_s = (per_call_ms(cuda_gemm.split_hi_lo, A)
                       + per_call_ms(cuda_gemm.split_hi_lo, B))
                moved_bytes = 8.0 * (m * k + k * n)
                print(f"K2 {tag} 'high' split pass of A and B: {t_s:.4f} ms "
                      f"of the call's {t_k:.4f} ms ({t_s / t_k:.1%}), "
                      f"{moved_bytes / 1e9:.2f} GB at "
                      f"{moved_bytes / (t_s * 1e-3) / 1e12:.2f} TB/s")
            if not good:
                fail(f"K2 {tag} {mode}: kernel and plain disagree ({check})")
            rows.append({"shape": tag, "mode": mode, "max_abs_err": diff,
                         "ms": t_k, "plain_ms": t_p, "library_ms": t_l,
                         "bound_ms": bound[0], "bound_by": bound[1]})
            del ref, got, R, R0
        del A, B, R32
        torch.cuda.empty_cache()
    return rows


def _sass_check(entries):
    """Each (library, kernel, opcodes, required) entry: count the opcodes
    in the kernel's SASS in the built library, by the CUDA toolkit's
    cuobjdump, and fail where a required one is missing (wgmma is HGMMA,
    TMA loads UTMALDG, mbarrier operations SYNCS, bulk copies UBLKCP)."""
    import os

    from conflux_tpu_torch.ops import _build

    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    if not os.path.exists(cuobjdump):
        fail(f"cuobjdump not found beside nvcc ({cuobjdump})")
    for lib, kernel, want, required in entries:
        sass = subprocess.run(
            [cuobjdump, "--dump-sass", str(_build._lib_path(lib))],
            capture_output=True, text=True, check=True).stdout
        counts = {op: 0 for op in want}
        for part in sass.split("Function : ")[1:]:
            if kernel in part.splitlines()[0]:
                for op in want:
                    counts[op] += part.count(op)
        print(f"SASS of {kernel} ({lib}): {counts} instructions")
        missing = [op for op, n in counts.items() if n == 0]
        if required and missing:
            fail(f"the SASS of {kernel} lacks {missing}")


def phase_k4():
    import torch

    from conflux_tpu_torch.ops import cuda_gemm
    from conflux_tpu_torch.ops.gemm import _matmul_t
    from conflux_tpu_torch.timing import per_call_ms

    _sass_check([("bigk_gemm", "matmul_wgmma_kernel",
                  ("HGMMA", "UTMALDG", "SYNCS"), True),
                 ("row_move", "bulk_move_kernel", ("UBLKCP", "SYNCS"),
                  False)])
    counters = ("MATMUL_LAUNCHES", "MATMUL_WGMMA_LAUNCHES",
                "MATMUL_MMA_SYNC_LAUNCHES")
    # the route counters each call must move: f32 FMA, bf16 on TMA-aligned
    # operands (wgmma), bf16 on views with an odd row stride (mma.sync)
    routes = {"float32": (1, 0, 0), "bfloat16 wgmma": (1, 1, 0),
              "bfloat16 mma.sync": (1, 0, 1)}
    rows = []
    for si, (m, k, n) in enumerate(K4_SHAPES):
        g = torch.Generator(device="cuda").manual_seed(1300 + si)
        A32 = torch.randn(m, k, generator=g, device="cuda")
        B32 = torch.randn(k, n, generator=g, device="cuda")
        for route, step in routes.items():
            dtype = torch.float32 if route == "float32" else torch.bfloat16
            A, B = A32.to(dtype), B32.to(dtype)
            if route == "bfloat16 mma.sync":
                A = torch.empty(m, k + 1, dtype=dtype,
                                device="cuda")[:, :k].copy_(A)
                B = torch.empty(k, n + 1, dtype=dtype,
                                device="cuda")[:, :n].copy_(B)
            before = [getattr(cuda_gemm, c) for c in counters]
            got = cuda_gemm.matmul(A, B)
            torch.cuda.synchronize()
            moved = tuple(getattr(cuda_gemm, c) - b
                          for c, b in zip(counters, before))
            if moved != step:
                fail(f"K4 [{m}, {k}, {n}] {route}: route counters moved "
                     f"{moved}, expected {step}")
            ref = _matmul_t(A, B)
            scale = float(torch.mm(A.float().abs(), B.float().abs()).max())
            diff = float((got - ref).abs().max())
            del ref, got
            # the library product: fp32 (TF32 off) or bf16 with fp32 output
            library = (torch.mm if dtype == torch.float32 else
                       lambda a, b: torch.mm(a, b, out_dtype=torch.float32))
            t_k, t_l = _in_turns(cuda_gemm.matmul, library, A, B)
            t_p = per_call_ms(_matmul_t, A, B)
            esize = A.element_size()
            bound = _bound(2.0 * m * n * k,
                           esize * (m * k + k * n) + 4.0 * m * n,
                           FP32_FLOP_S if dtype == torch.float32
                           else BF16_FLOP_S)
            tflops = 2.0 * m * n * k / (t_k * 1e-3) / 1e12
            lib_tflops = 2.0 * m * n * k / (t_l * 1e-3) / 1e12
            print(f"K4 [{m}, {k}] @ [{k}, {n}] {route:17s}: max|diff| "
                  f"{diff:.3e}, rel to max(|A|@|B|) {diff / scale:.3e} (gate "
                  f"{K3_TOL:.0e}), kernel {t_k:.4f} ms ({tflops:.1f} "
                  f"TFLOP/s), plain {t_p:.4f} ms, torch.mm {t_l:.4f} ms "
                  f"({lib_tflops:.1f} TFLOP/s), bound {bound[0]:.4f} ms "
                  f"({bound[1]}, {bound[0] / t_k:.1%} of it)")
            if not diff <= K3_TOL * scale:
                fail(f"K4 [{m}, {k}, {n}] {route}: kernel and plain disagree")
            rows.append({"shape": (m, k, n), "route": route,
                         "max_abs_err": diff, "ms": t_k, "plain_ms": t_p,
                         "library_ms": t_l, "bound_ms": bound[0],
                         "bound_by": bound[1]})
            del A, B
        del A32, B32
        torch.cuda.empty_cache()
    return rows


def phase_rows():
    import torch

    from conflux_tpu_torch.ops import cuda_scatter
    from conflux_tpu_torch.ops.scatter import _gather_rows_t, _scatter_rows_t
    from conflux_tpu_torch.timing import per_call_ms

    g = torch.Generator(device="cuda").manual_seed(1400)
    R32 = torch.randn(N, N, generator=g, device="cuda")
    rows = []
    moves = [(dtype, kind, w, None) for dtype in (torch.float32,
                                                   torch.bfloat16)
             for kind, w in ROW_MOVES]
    moves.append((torch.float32, "gather", N - V, PANEL_SLICE))
    for dtype, kind, w, cols in moves:
        R = R32 if dtype == torch.float32 else R32.to(torch.bfloat16)
        if cols is not None:
            R = R[:, cols[0]:cols[1]]
        width = R.shape[1]
        name = str(dtype).replace("torch.", "")
        idx = torch.randperm(N, generator=g, device="cuda")[:w]
        bulk = (cuda_scatter.SCATTER_ROWS_BULK_LAUNCHES
                + cuda_scatter.GATHER_ROWS_BULK_LAUNCHES)
        if kind == "gather":
            ref = _gather_rows_t(R, idx)
            got = cuda_scatter.gather_rows(R, idx)
            torch.cuda.synchronize()
            same = torch.equal(got, ref)
            del ref, got
            t_k, t_l = _in_turns(cuda_scatter.gather_rows,
                                 lambda r, i: torch.index_select(r, 0, i),
                                 R, idx)
            t_p = per_call_ms(_gather_rows_t, R, idx)
        else:
            src = torch.randn(w, N, generator=g, device="cuda").to(dtype)
            ref = _scatter_rows_t(R.clone(), src, idx)
            got = cuda_scatter.scatter_rows(R.clone(), src, idx)
            torch.cuda.synchronize()
            same = torch.equal(got, ref)
            del ref, got
            # repeated in place: the same rows get the same values
            Rw = R.clone()
            t_k, t_l = _in_turns(cuda_scatter.scatter_rows,
                                 lambda r, s, i: r.index_copy_(0, i, s),
                                 Rw, src, idx)
            t_p = per_call_ms(_scatter_rows_t, Rw, src, idx)
            del Rw, src
        # every move here has 16-byte rows, starts and strides
        if (cuda_scatter.SCATTER_ROWS_BULK_LAUNCHES
                + cuda_scatter.GATHER_ROWS_BULK_LAUNCHES) == bulk:
            fail(f"{kind} of {w} rows did not take the bulk-copy route")
        moved = 2.0 * w * width * R.element_size()
        bound = _bound(0.0, moved + 8.0 * w, BF16_FLOP_S)
        gbs = moved / (t_k * 1e-3) / 1e9
        of = (f"[{N}, {N}]" if cols is None else
              f"T[:, {cols[0]}:{cols[1]}] of [{N}, {N}]")
        tag = f"K{5 if kind == 'scatter' else 6} {kind} {w} rows of {of} " \
              f"{name}"
        print(f"{tag}: bit-exact {same}, kernel {t_k:.4f} ms "
              f"({gbs:.0f} GB/s), plain {t_p:.4f} ms, library "
              f"{t_l:.4f} ms, bound {bound[0]:.4f} ms ({bound[1]})")
        if not same:
            fail(f"{tag}: kernel and plain differ")
        rows.append({"kind": kind, "rows": w, "width": width, "dtype": name,
                     "max_abs_err": 0.0, "ms": t_k, "plain_ms": t_p,
                     "library_ms": t_l, "bound_ms": bound[0],
                     "bound_by": bound[1]})
        del idx, R
        torch.cuda.empty_cache()
    del R32
    torch.cuda.empty_cache()
    return rows


def _check_factor(A, F, perm, tag: str) -> float:
    import torch

    from conflux_tpu_torch.validation import lu_residual_blocked

    n = A.shape[0]
    if tuple(F.shape) != (n, n) or tuple(perm.shape) != (n,):
        fail(f"{tag}: shapes F {tuple(F.shape)} perm {tuple(perm.shape)}")
    if not bool(torch.isfinite(F).all()):
        fail(f"{tag}: non-finite factor")
    if not torch.equal(torch.sort(perm).values,
                       torch.arange(n, device=perm.device)):
        fail(f"{tag}: perm is not a permutation")
    res = lu_residual_blocked(A, F, perm)
    if not res <= RESIDUAL_GATE:
        fail(f"{tag}: residual {res} > {RESIDUAL_GATE}")
    return res


def _check_cholesky(A, L, tag: str) -> float:
    import torch

    from conflux_tpu_torch.validation import cholesky_residual_blocked

    n = A.shape[0]
    if tuple(L.shape) != (n, n) or not bool(torch.isfinite(L).all()):
        fail(f"{tag}: factor of shape {tuple(L.shape)} is not finite")
    if not torch.equal(L, torch.tril(L)):
        fail(f"{tag}: factor is not lower triangular")
    res = cholesky_residual_blocked(A, L)
    if not res <= RESIDUAL_GATE:
        fail(f"{tag}: residual {res} > {RESIDUAL_GATE}")
    return res


def _solve_residual(A, x, b) -> float:
    """||A x - b|| / (||A|| ||x||) in float64 on the host."""
    A, x, b = (t.double().cpu().numpy() for t in (A, x, b))
    return float(np.linalg.norm(A @ x - b)
                 / (np.linalg.norm(A) * np.linalg.norm(x)))


def phase_small():
    import torch

    from conflux_tpu_torch.cholesky.single import cholesky
    from conflux_tpu_torch.lu.single import lu_factor
    from conflux_tpu_torch.solve import cho_solve, lu_solve
    from conflux_tpu_torch.validation import (
        cholesky_residual_dense,
        lu_residual_dense,
    )

    n = 2048
    g = torch.Generator(device="cuda").manual_seed(7)
    A = torch.randn(n, n, generator=g, device="cuda")
    b = torch.randn(n, generator=g, device="cuda")
    for scheme, compaction in (("crout", "gather"), ("crout", "split"),
                               ("crout", "swap"), ("flat", "gather"),
                               ("recursive", "gather")):
        for prec in ("high", "highest"):
            F, perm = lu_factor(A, v=256, precision=prec, scheme=scheme,
                                compaction=compaction)
            torch.cuda.synchronize()
            tag = f"LU {scheme} N={n} {prec}"
            if compaction != "gather":
                tag = f"LU {scheme} {compaction} N={n} {prec}"
            res = _check_factor(A, F, perm, tag)
            # an independent float64 host reconstruction as the reference
            dense = lu_residual_dense(A.cpu().numpy(), F.cpu().numpy(),
                                      perm.cpu().numpy())
            msg = (f"{tag} v=256: lu_residual_blocked {res:.3e}, float64 "
                   f"host residual {dense:.3e}")
            if not dense <= RESIDUAL_GATE:
                fail(f"{tag}: float64 residual {dense}")
            if scheme == "flat" and prec == "highest":
                # a 'high' factor's backward error (~N * its residual,
                # 2.7e-4 here) puts this gate out of its reach
                sres = _solve_residual(A, lu_solve(F, perm, b), b)
                msg += f", lu_solve residual {sres:.3e}"
                if not sres <= RESIDUAL_GATE:
                    fail(f"lu_solve residual {sres}")
            print(msg)
    X = torch.rand(n, n, generator=g, device="cuda")
    S = (X + X.T) / 2 + n * torch.eye(n, device="cuda")
    for scheme in ("flat", "recursive"):
        for prec in ("high", "highest"):
            L = cholesky(S, v=256, precision=prec, scheme=scheme)
            torch.cuda.synchronize()
            tag = f"Cholesky {scheme} N={n} {prec}"
            res = _check_cholesky(S, L, tag)
            dense = cholesky_residual_dense(S.cpu().numpy(), L.cpu().numpy())
            msg = (f"{tag} v=256: cholesky_residual_blocked {res:.3e}, "
                   f"float64 host residual {dense:.3e}")
            if not dense <= RESIDUAL_GATE:
                fail(f"{tag}: float64 residual {dense}")
            if scheme == "flat" and prec == "high":
                sres = _solve_residual(S, cho_solve(L, b), b)
                msg += f", cho_solve residual {sres:.3e}"
                if not sres <= RESIDUAL_GATE:
                    fail(f"cho_solve residual {sres}")
            print(msg)
    _tf32_check(A, S, b)


def _entry_results(A, S, b) -> dict:
    """crout, flat and Cholesky at 'highest', both solves and the blocked
    residuals, by name."""
    import torch

    from conflux_tpu_torch.cholesky.single import cholesky
    from conflux_tpu_torch.lu.single import lu_factor
    from conflux_tpu_torch.solve import cho_solve, lu_solve
    from conflux_tpu_torch.validation import (
        cholesky_residual_blocked,
        lu_residual_blocked,
    )

    out = {}
    for scheme in ("crout", "flat"):
        F, perm = lu_factor(A, v=256, scheme=scheme)
        out.update({f"{scheme} F": F, f"{scheme} perm": perm,
                    f"{scheme} residual": torch.tensor(
                        lu_residual_blocked(A, F, perm)),
                    f"{scheme} lu_solve": lu_solve(F, perm, b)})
    L = cholesky(S, v=256)
    out.update({"Cholesky L": L, "Cholesky residual": torch.tensor(
        cholesky_residual_blocked(S, L)), "cho_solve": cho_solve(L, b)})
    torch.cuda.synchronize()
    return out


def _tf32_check(A, S, b):
    """With the caller's TF32 on, first through the legacy knobs and then
    through `fp32_precision`, every entry point gives the bits it gives
    with the defaults, and the caller's knobs read back as set; they are
    restored before the next phase. An unpinned fp32 torch.mm under the
    same setting shows that TF32 was really on."""
    import torch

    knobs = (torch.backends.cuda.matmul, torch.backends.mkldnn.matmul)
    saved = [k.fp32_precision for k in knobs]
    ref = _entry_results(A, S, b)
    mm = torch.mm(A, A)
    for api in ("legacy", "fp32_precision"):
        if api == "legacy":
            torch.backends.cuda.matmul.allow_tf32 = True
            torch.set_float32_matmul_precision("high")
        else:
            torch.backends.cuda.matmul.fp32_precision = "tf32"
        state = [k.fp32_precision for k in knobs]
        got = _entry_results(A, S, b)
        back = [k.fp32_precision for k in knobs]
        legacy_back = (api != "legacy" or (
            torch.backends.cuda.matmul.allow_tf32 is True
            and torch.get_float32_matmul_precision() == "high"))
        tf32_diff = float((torch.mm(A, A) - mm).abs().max())
        if api == "legacy":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.set_float32_matmul_precision("highest")
        for knob, value in zip(knobs, saved):
            knob.fp32_precision = value
        differ = [name for name in ref if not torch.equal(ref[name],
                                                           got[name])]
        print(f"TF32 on through {api} ({state}): {len(ref) - len(differ)} "
              f"of {len(ref)} results bit-identical to the defaults' "
              f"(crout, flat, Cholesky, both solves, residuals at 'highest' "
              f"N={A.shape[0]}); caller's knobs read back {back}; an "
              f"unpinned fp32 torch.mm moved by up to {tf32_diff:.3e}")
        if back != state or not legacy_back:
            fail(f"TF32 via {api}: the caller's settings came back as {back}")
        if differ:
            fail(f"TF32 via {api}: {differ} differ from the defaults' run")
        if tf32_diff == 0.0:
            fail(f"TF32 via {api}: an unpinned torch.mm did not change, so "
                 "the check proves nothing")


def _counters():
    """Each kernel's launch counter: (module, attribute) by kernel name."""
    from conflux_tpu_torch.ops import cuda_gemm, cuda_lower_solve, \
        cuda_panel, cuda_scatter

    return {"rank1_panel": (cuda_panel, "LAUNCHES"),
            "schur_update": (cuda_gemm, "SCHUR_UPDATE_LAUNCHES"),
            "sub_matmul_bigk": (cuda_gemm, "SUB_MATMUL_BIGK_LAUNCHES"),
            "matmul": (cuda_gemm, "MATMUL_LAUNCHES"),
            "scatter_rows": (cuda_scatter, "SCATTER_ROWS_LAUNCHES"),
            "gather_rows": (cuda_scatter, "GATHER_ROWS_LAUNCHES"),
            "rank1_panel_f64": (cuda_panel, "LAUNCHES_F64"),
            "sub_matmul_bigk_bf16": (cuda_gemm,
                                     "SUB_MATMUL_BIGK_BF16_LAUNCHES"),
            "sub_matmul_bigk_bf16 tiles": (
                cuda_gemm, "SUB_MATMUL_BIGK_BF16_TILES_LAUNCHES"),
            "sub_matmul_bigk_bf16 registers": (
                cuda_gemm, "SUB_MATMUL_BIGK_BF16_REGISTERS_LAUNCHES"),
            "sub_matmul_bigk_bf16 split-k": (
                cuda_gemm, "SUB_MATMUL_BIGK_BF16_SPLITK_LAUNCHES"),
            "sub_matmul_bigk_bf16 cooperative": (
                cuda_gemm, "SUB_MATMUL_BIGK_BF16_COOP_LAUNCHES"),
            "sub_matmul_bigk_bf16 k-major": (
                cuda_gemm, "SUB_MATMUL_BIGK_BF16_KMAJOR_LAUNCHES"),
            "sub_matmul_bigk_bf16 copies": (
                cuda_gemm, "SUB_MATMUL_BIGK_BF16_COPIES"),
            # routes, counted apart
            "rank1_panel cluster": (cuda_panel, "LAUNCHES_CLUSTER"),
            "rank1_panel grid": (cuda_panel, "LAUNCHES_GRID"),
            "rank1_panel grid clustered": (cuda_panel,
                                           "LAUNCHES_GRID_CLUSTERED"),
            "rank1_panel tile": (cuda_panel, "LAUNCHES_TILE"),
            "rank1_panel_f64 cluster": (cuda_panel, "LAUNCHES_F64_CLUSTER"),
            "rank1_panel_f64 grid": (cuda_panel, "LAUNCHES_F64_GRID"),
            "rank1_panel_f64 tile": (cuda_panel, "LAUNCHES_F64_TILE"),
            "schur_update wgmma": (cuda_gemm, "SCHUR_UPDATE_WGMMA_LAUNCHES"),
            "sub_matmul_bigk wgmma": (cuda_gemm,
                                      "SUB_MATMUL_BIGK_WGMMA_LAUNCHES"),
            "matmul wgmma": (cuda_gemm, "MATMUL_WGMMA_LAUNCHES"),
            "matmul mma.sync": (cuda_gemm, "MATMUL_MMA_SYNC_LAUNCHES"),
            "scatter_rows bulk": (cuda_scatter,
                                  "SCATTER_ROWS_BULK_LAUNCHES"),
            "gather_rows bulk": (cuda_scatter, "GATHER_ROWS_BULK_LAUNCHES"),
            "lower_solve": (cuda_lower_solve, "LAUNCHES")}


def _reset_counts():
    for mod, attr in _counters().values():
        setattr(mod, attr, 0)


def _counts():
    return {name: getattr(mod, attr)
            for name, (mod, attr) in _counters().items()}


def _timed_path(fn, *args):
    """One warm-up and REPS timed runs of fn(*args), with each kernel's
    launches per run; returns (times ms, launches per run, last result)."""
    from conflux_tpu_torch.timing import timed_run

    times, per_run = [], []
    out = None
    for rep in range(REPS + 1):
        before = _counts()
        out = None                    # the previous result's memory is free
        ms, out = timed_run(fn, *args)
        after = _counts()
        per_run.append({k: after[k] - before[k] for k in after})
        if rep:                                   # rep 0 is the warm-up
            times.append(ms)
    return times, per_run, out


def _path_want(path: str) -> dict:
    """Launches per factorization of `path` (a main path or a dtype path):
    each kernel's, K1's per route (ROUTE_LAUNCHES, derived from the step
    loop once the card's cluster route is known; a dtype path's K1 blocks
    are its base path's, on the float32 kernel or, for float64, all on K1
    in double, whose routes ROUTE_LAUNCHES_F64 holds) and K3's and K2's
    on their wgmma route."""
    if path in DTYPE_PATHS:
        base, table = DTYPE_PATHS[path]
    else:
        base, table = path, PATH_LAUNCHES[path]
    want = {k: table.get(k, 0) for k in KERNELS}
    want.update({f"{k} {r}": 0 for r in K1_ROUTES
                 for k in ("rank1_panel", "rank1_panel_f64")})
    want["rank1_panel grid clustered"] = 0
    if want["rank1_panel"]:
        want.update(ROUTE_LAUNCHES[base])
    if want["rank1_panel_f64"]:
        want.update(ROUTE_LAUNCHES_F64[base])
    want["schur_update wgmma"] = want["schur_update"]
    want["sub_matmul_bigk wgmma"] = want["sub_matmul_bigk"]
    want.update({f"sub_matmul_bigk_bf16 {r}": 0 for r in BF16_COUNTS})
    if want["sub_matmul_bigk_bf16"]:
        want.update(BF16_ROUTE_LAUNCHES[path])
    want["lower_solve"] = lower_solve_launches(path)
    return want


def _expect(per_run, want: dict, tag: str):
    for name, n in want.items():
        got = [c[name] for c in per_run]
        if any(c != n for c in got):
            fail(f"{tag}: {name} launches per factorization {got}, "
                 f"expected {n}")


def phase_lu_path(smi: str, path: str):
    """One LU path: 'crout', 'recursive' and 'flat' by scheme, 'swap' and
    'split' as crout's compactions."""
    import torch

    from conflux_tpu_torch.lu.single import lu_factor

    scheme = path if path in ("recursive", "flat") else "crout"
    compaction = path if path in ("swap", "split") else "gather"
    g = torch.Generator(device="cuda").manual_seed(42)
    A = 5.0 + torch.rand(N, N, generator=g, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    times, per_run, (F, perm) = _timed_path(
        lambda a: lu_factor(a, V, "high", scheme=scheme,
                            compaction=compaction), A)
    counts = _counts()
    peak = torch.cuda.max_memory_allocated()
    _expect(per_run, _path_want(path), f"{path} N={N}")
    if path == "crout":
        # the cells' path: every grid-route block in clusters
        outside = [c["rank1_panel grid"] - c["rank1_panel grid clustered"]
                   for c in per_run]
        if any(outside):
            fail(f"crout N={N}: grid-route launches outside clusters "
                 f"{outside}")
    med = statistics.median(times)
    res = _check_factor(A, F, perm, f"{path} N={N} high")
    print(f"{path} path N={N} v={V} 'high' on {smi}: times ms "
          f"{[round(t, 3) for t in times]}, median {med:.3f} ms, "
          f"{2.0 / 3.0 * N ** 3 / (med * 1e-3) / 1e9:.1f} GFLOP/s, "
          f"peak memory {peak / 2 ** 30:.3f} GiB = "
          f"{peak / A.nbytes:.3f} copies of A, launches per "
          f"factorization {per_run[-1]}, lu_residual_blocked {res:.3e}")
    return counts


def phase_auto(smi: str):
    """lu_factor(A, V, 'high') with no scheme on the main paths' input at
    N, and, where N is at or past auto_scheme's threshold, at one row
    below the threshold (the other side; ragged leaves when the threshold
    is not a multiple of V): each run's launches must be exactly those of
    the path `auto_scheme` names for its N, and its blocked residual
    within the gate. Returns the launches."""
    import torch

    from conflux_tpu_torch.lu.single import CROUT_FROM_M, auto_scheme, \
        lu_factor
    from conflux_tpu_torch.timing import timed_run

    sizes = [N] + ([CROUT_FROM_M - 1] if 1 < CROUT_FROM_M <= N else [])
    total = {}
    for n in sizes:
        g = torch.Generator(device="cuda").manual_seed(42)
        A = 5.0 + torch.rand(n, n, generator=g, device="cuda")
        path = auto_scheme(n)
        lu_factor(A, V, "high")                      # warm-up at this n
        torch.cuda.synchronize()
        _reset_counts()
        ms, (F, perm) = timed_run(lambda: lu_factor(A, V, "high"))
        counts = _counts()
        _expect([counts], _loop_want(path, n, V), f"auto N={n}")
        res = _check_factor(A, F, perm, f"auto N={n} high")
        print(f"auto N={n} v={V} 'high' on {smi}: auto_scheme({n}) = "
              f"{path!r} (crout from {CROUT_FROM_M} rows), {ms:.3f} ms, "
              f"launches {counts['rank1_panel']} K1, "
              f"{counts['sub_matmul_bigk']} K2, {counts['schur_update']} "
              f"K3 as derived for {path}, lu_residual_blocked {res:.3e}")
        for k, c in counts.items():
            total[k] = total.get(k, 0) + c
        del A, F, perm
    return total


def phase_cholesky_path(smi: str):
    import torch

    from conflux_tpu_torch.cholesky.single import cholesky

    g = torch.Generator(device="cuda").manual_seed(43)
    A = torch.rand(N, N, generator=g, device="cuda")
    A = A + A.T                      # a fresh tensor: X + X^T
    A.mul_(0.5)
    A.diagonal().add_(float(N))      # SPD by Gershgorin
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    times, per_run, L = _timed_path(lambda a: cholesky(a, V, "high"), A)
    counts = _counts()
    peak = torch.cuda.max_memory_allocated()
    _expect(per_run, _path_want("cholesky"), f"Cholesky N={N}")
    med = statistics.median(times)
    res = _check_cholesky(A, L, f"Cholesky N={N} high")
    print(f"Cholesky path N={N} v={V} 'high' on {smi}: times ms "
          f"{[round(t, 3) for t in times]}, median {med:.3f} ms, "
          f"{N ** 3 / 3.0 / (med * 1e-3) / 1e9:.1f} GFLOP/s, "
          f"peak memory {peak / 2 ** 30:.3f} GiB, launches per "
          f"factorization {per_run[-1]}, cholesky_residual_blocked "
          f"{res:.3e}")
    return counts


def _dtype_inputs(path: str):
    """The dtype phase's input of `path`, made on the card from a seed:
    chip_smoke's LU input 5 + U(0, 1) (seed 42), its Cholesky input
    (X + X^T)/2 + N I (seed 43), rounded to bf16 by torch or made in f64;
    for the complex LU, (5 + U(0, 1)) + i U(0, 1) at C64_N (seed 42)."""
    import torch

    g = torch.Generator(device="cuda")
    if path == "c64 clu":
        g.manual_seed(42)
        re = 5.0 + torch.rand(C64_N, C64_N, generator=g, device="cuda")
        im = torch.rand(C64_N, C64_N, generator=g, device="cuda")
        return torch.complex(re, im)
    bf16 = path.startswith("bf16")
    made = torch.float32 if bf16 else torch.float64
    if path.endswith("cholesky"):
        g.manual_seed(43)
        A = torch.rand(N, N, generator=g, device="cuda", dtype=made)
        A = A + A.T
        A.mul_(0.5)
        A.diagonal().add_(float(N))
    else:
        g.manual_seed(42)
        A = 5.0 + torch.rand(N, N, generator=g, device="cuda", dtype=made)
    return A.to(torch.bfloat16) if bf16 else A


def phase_dtypes(smi: str):
    """The dtype paths at full width: bf16 storage crout 'gather', flat
    and Cholesky, float64 crout and Cholesky at N, V; complex64
    clu_factor at C64_N. Each: one warm-up and REPS timed factorizations
    with every kernel's launches per run held to DTYPE_PATHS, the peak
    device memory, and the JAX package's gate on the blocked residual.
    Returns each path's launches."""
    import torch

    from conflux_tpu_torch.cholesky.single import cholesky
    from conflux_tpu_torch.lu.csingle import clu_factor
    from conflux_tpu_torch.lu.single import lu_factor
    from conflux_tpu_torch.validation import cholesky_residual_blocked, \
        lu_residual_blocked

    runs = {
        "bf16 crout": lambda a: lu_factor(a, V, "high"),
        "bf16 flat": lambda a: lu_factor(a, V, "high", scheme="flat"),
        "bf16 cholesky": lambda a: cholesky(a, V, "high"),
        "f64 crout": lambda a: lu_factor(a, V, "high", scheme="crout"),
        "f64 cholesky": lambda a: cholesky(a, V, "high"),
        "c64 clu": lambda a: clu_factor(a, V),
    }
    from conflux_tpu_torch.ops import panel

    plain_k1 = panel._rank1_block_t

    def refuse(*args, **kwargs):
        fail("the plain K1 ran on a CUDA block")

    out = {}
    for path, fn in runs.items():
        torch.cuda.empty_cache()
        A = _dtype_inputs(path)
        n = A.shape[0]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        # no CUDA panel block may reach K1's plain version
        panel._rank1_block_t = refuse
        try:
            times, per_run, res = _timed_path(fn, A)
        finally:
            panel._rank1_block_t = plain_k1
        out[path] = _counts()
        peak = torch.cuda.max_memory_allocated()
        _expect(per_run, _path_want(path), f"{path} N={n}")
        if path.endswith("cholesky"):
            F, perm = res, None
            if not torch.equal(F, torch.tril(F)):
                fail(f"{path}: factor is not lower triangular")
            gate = cholesky_residual_blocked(A, F)
        else:
            F, perm = res
            if not torch.equal(torch.sort(perm).values,
                               torch.arange(n, device=perm.device)):
                fail(f"{path}: perm is not a permutation")
            gate = lu_residual_blocked(A, F, perm)
        if F.dtype != A.dtype or not bool(torch.isfinite(F).all()):
            fail(f"{path}: factor {F.dtype} (input {A.dtype}) or not finite")
        med = statistics.median(times)
        flops = (n ** 3 / 3.0 if path.endswith("cholesky")
                 else 2.0 / 3.0 * n ** 3)
        note = (" (its panel is the JAX package's per-column loop, eager "
                "here: no kernel in either package; N cut from 32768)"
                if path == "c64 clu" else "")
        print(f"dtype path {path} N={n} v={V}{note} on {smi}: times ms "
              f"{[round(t, 3) for t in times]}, median {med:.3f} ms, "
              f"{flops / (med * 1e-3) / 1e9:.1f} GFLOP/s, peak memory "
              f"{peak / 2 ** 30:.3f} GiB, factor {F.dtype}, launches per "
              f"factorization {per_run[-1]}, blocked residual {gate:.3e} "
              f"(gate {DTYPE_GATES[path]:.3e})")
        if not gate < DTYPE_GATES[path]:
            fail(f"{path}: residual {gate} over its gate "
                 f"{DTYPE_GATES[path]}")
        del A, F, perm, res
    torch.cuda.empty_cache()
    return out


def dist_k1_blocks(program: str, n: int = DIST_N, v: int = DIST_V,
                   shape=DIST_GRID):
    """(w, m, forced) of every K1 block ONE rank of a `shape` grid
    launches in one run of `program`, from the rank programs' step loops
    (every rank launches the same blocks). 'windowed' and 'fori' (the
    right-looking lu_25d, tournament): per step, the local round over the
    rank's mr working rows in 64-wide blocks (ops/panel._BLOCK), the
    merge rounds over 2v candidates ((Px - 1).bit_length() of them) and
    the forced refactor of the v winners; mr shrinks to the row frontier
    at each window start ('windowed', never on 'fori'). 'crout': the same
    at Px > 1, with a rebalance every crout_rowpart_default(Px, Nt) steps;
    at Px == 1 the fused panel instead, 128-wide blocks over mr rows (K1
    unforced with finish). 'cholesky' (cholesky_25d, any variant): per
    step, the forced [v, v] diagonal tile."""
    from conflux_tpu_torch.dispatch import segment_bounds
    from conflux_tpu_torch.lu.p25d import _row_frontier, \
        crout_rowpart_default

    Px = shape[0]
    Nt = n // v
    per = v // 64
    if program == "cholesky":
        return [(64, v, True)] * (Nt * per)
    if program == "windowed":
        starts = {lo for lo, _ in segment_bounds(Nt, DIST_WINDOWS) if lo > 0}
    elif program == "crout":
        rp = crout_rowpart_default(Px, Nt)
        starts = {k for k in range(1, Nt) if k % rp == 0}
    else:
        starts = set()
    blocks = []
    mr = n // Px
    rounds = (Px - 1).bit_length()
    for k in range(Nt):
        if k in starts:
            mr = min(mr, _row_frontier(n, k, v, Px))
        if program == "crout" and Px == 1:
            blocks += [(128, mr, False)] * (v // 128)
            continue
        blocks += ([(64, mr, False)] * per
                   + [(64, 2 * v, False)] * (per * rounds)
                   + [(64, v, True)] * per)
    return blocks


def _dist_want(program: str, route, n: int, v: int, shape,
               precision: str, dtype: str = "float32") -> dict:
    """Each counter's launches on one rank in one run of `program`: K1's
    in all and per route (route(w, m, forced) names a block's route on
    this card), K3's one per right-looking LU step in 'high' (or under
    bf16 storage, 'bf16out') where l = v / Pz is a multiple of 128
    (`_trailing_sub`'s condition), every other kernel's none. float64
    runs every K1 block on K1 in double (route: its route_f64) and no K3;
    the complex LU ('clu') launches no kernel."""
    from conflux_tpu_torch.ops import cuda_panel

    want = {name: 0 for name in _counters()}
    if program == "clu":
        return want
    blocks = dist_k1_blocks(program, n, v, shape)
    if dtype == "float64":
        want["rank1_panel_f64"] = len(blocks)
        taken = [route(*b) for b in blocks]
        for r in K1_ROUTES:
            want[f"rank1_panel_f64 {r}"] = taken.count(r)
        return want
    want["rank1_panel"] = len(blocks)
    taken = [route(*b) for b in blocks]
    for r in K1_ROUTES:
        want[f"rank1_panel {r}"] = taken.count(r)
    want["rank1_panel grid clustered"] = k1_clustered(
        blocks, route, cuda_panel.grid_cluster)
    if (program in ("windowed", "fori")
            and (precision == "high" or dtype == "bfloat16")
            and (v // shape[2]) % 128 == 0):
        want["schur_update"] = want["schur_update wgmma"] = n // v
    return want


def _dist_runs(n: int, v: int):
    """(name, algorithm, shape, n, v, precision, unroll, what, dtype) of
    each factorization of the dist phase; shape and v None: the entry
    points' defaults (pdgetrf / pdpotrf). The dtype runs: 'windowed' and
    'crout' LU and the auto-variant Cholesky under bf16 storage and in
    float64, at N / 2 and v / 2 (l = v / (2 Pz) = 128: K3 runs every
    bf16 'windowed' step), and the complex64 LU at N / 4 and v / 2 (its
    eager per-column panel loop took 54 s of the phase at N / 2)."""
    half = n // 2
    dtype_runs = tuple(
        run + (dtype,)
        for dtype, tag in (("bfloat16", "bf16"), ("float64", "f64"))
        for run in (
            (f"lu_25d windowed {tag}", "lu", DIST_GRID, half, v // 2, "high",
             "windowed", f"tournament, {tag} storage"),
            (f"lu_25d crout {tag}", "lu", DIST_GRID, half, v // 2, "high",
             "crout", f"tournament, {tag} storage"),
            (f"cholesky_25d {tag}", "cholesky", DIST_GRID, half, v // 2,
             "high", None, f"auto variant, {tag} storage")))
    return tuple(run + ("float32",) for run in (
        ("lu_25d", "lu", DIST_GRID, n, v, "high", None,
         "tournament, auto variant"),
        ("cholesky_25d", "cholesky", DIST_GRID, n, v, "high", None,
         "auto variant"),
        ("lu_25d crout", "lu", DIST_GRID, n, v, "high", "crout",
         "tournament, the left-looking program"),
        ("lu_25d crout fused", "lu", DIST_CROUT_GRID, half, v, "high",
         "crout", "tournament, Px = 1: the fused panel"),
        ("pdgetrf", "lu", None, half, None, "highest", None,
         "its default grid, tile and variant"),
        ("pdpotrf", "cholesky", None, half, None, "highest", None,
         "its default grid, tile and variant"),
        ("lu_25d_profiled", "lu", DIST_GRID, half, v, "high", False,
         "substep regions, each fenced"),
        ("lu_25d fori", "lu", DIST_GRID, half, v, "high", False,
         "the profiled run's unprofiled twin"),
    )) + dtype_runs + (
        ("clu_25d c64", "clu", DIST_GRID, n // 4, v // 2, None, "fori",
         "tournament, '4m' products, complex64", "complex64"),)


# the distributed gates, by dtype: the reference's 1e-6, the JAX
# package's bf16 storage bounds (LU tests/test_lu_dist.py:404, Cholesky
# tests/test_cholesky_dist.py:217), its f64 bound (tests/test_f64_mode.py)
# and its complex64 bound (tests/test_complex.py:164)
DIST_GATES = {("float32", "lu"): 1e-6, ("float32", "cholesky"): 1e-6,
              ("bfloat16", "lu"): 6e-4, ("bfloat16", "cholesky"): 2e-4,
              ("float64", "lu"): 1e-14, ("float64", "cholesky"): 1e-14,
              ("complex64", "clu"): 1e-6}


def _run_shape(name, algorithm, shape, n, v):
    """(grid shape, v, rank-program variant) of one run of the dist phase,
    as the entry points choose them for a world of DIST_GRID's size."""
    from types import SimpleNamespace

    from conflux_tpu_torch.dispatch import choose_variant
    from conflux_tpu_torch.grid import choose_grid_cholesky, \
        choose_grid_lu, choose_tile_cholesky
    from conflux_tpu_torch.layout import BlockCyclic

    P = DIST_GRID[0] * DIST_GRID[1] * DIST_GRID[2]
    if shape is None:
        shape = (choose_grid_lu(n, n, P) if algorithm == "lu"
                 else choose_grid_cholesky(P, n))
        v = choose_tile_cholesky(n, shape, P)
    if algorithm == "clu":
        return shape, v, "fori"      # clu_25d has the one program
    Px, Py, Pz = shape
    # a descriptor on the grid's shape alone: no process group needed
    grid = SimpleNamespace(Px=Px, Py=Py, Pz=Pz, P=Px * Py * Pz)
    return shape, v, choose_variant(BlockCyclic.create(n, n, v, grid),
                                    algorithm)


def _dist_inputs(n: int, dev: str):
    """chip_smoke's LU input (5 + U(0, 1), seed 42) and Cholesky input
    ((X + X^T)/2 + n I, X ~ U(0, 1), seed 43: SPD by Gershgorin), made on
    the card from a seed."""
    import torch

    g = torch.Generator(device=dev).manual_seed(42)
    A = 5.0 + torch.rand(n, n, generator=g, device=dev)
    g = torch.Generator(device=dev).manual_seed(43)
    S = torch.rand(n, n, generator=g, device=dev)
    S = S + S.T
    S.mul_(0.5)
    S.diagonal().add_(float(n))
    return A, S


def _ipiv_walk(ipiv, n: int):
    """The row order LAPACK's sequential swaps give: rows i and
    ipiv[i] - 1 swapped in turn, for i = 0 .. n - 1."""
    p = np.arange(n)
    for i, j in enumerate(np.asarray(ipiv)[:n] - 1):
        p[i], p[j] = p[j], p[i]
    return p


def _dist_rank(n: int, v: int, check):
    """One rank of the dist phase (runs in its own process). Each
    factorization of `_dist_runs`: distribute, the rank program with
    every launch counter set to 0 just before it and read just after, the
    SUMMA residual gate on the distributed blocks (every rank), then the
    gather to grid rank 0, which checks the gathered factor with the
    blocked gate. Then the retile round trip, and the 'full'-pivot parity
    run on grid rank 0."""
    import torch
    import torch.distributed as dist

    from conflux_tpu_torch import profiler
    from conflux_tpu_torch.cholesky.p25d import cholesky_25d
    from conflux_tpu_torch.grid import make_grid
    from conflux_tpu_torch.layout import BlockCyclic, distribute, retile, \
        undistribute
    from conflux_tpu_torch.lu.cp25d import clu_25d
    from conflux_tpu_torch.lu.p25d import lu_25d, plu
    from conflux_tpu_torch.lu.profiled import lu_25d_profiled
    from conflux_tpu_torch.lu.single import lu_factor
    from conflux_tpu_torch.scalapack import pdgetrf, pdpotrf
    from conflux_tpu_torch.validation import (
        cholesky_residual_blocked,
        cholesky_residual_dist,
        lu_residual_blocked,
        lu_residual_dist,
    )

    def sync():
        torch.cuda.synchronize()

    grids = {DIST_GRID: make_grid(DIST_GRID, device="cuda"),
             DIST_CROUT_GRID: make_grid(DIST_CROUT_GRID, device="cuda")}
    out = {"rank": dist.get_rank(), "device": str(grids[DIST_GRID].device)}
    inputs = {m: _dist_inputs(m, "cuda")
              for m in sorted({run[3] for run in _dist_runs(n, v)})}
    kept = {}
    for (name, algorithm, shape, m, vv, precision, unroll,
         _, dtype) in _dist_runs(n, v):
        A, S = inputs[m]
        M = S if algorithm == "cholesky" else A
        if dtype == "complex64":
            g = torch.Generator(device="cuda").manual_seed(45)
            M = torch.complex(M, torch.rand(m, m, generator=g,
                                            device="cuda"))
        else:
            M = M.to(getattr(torch, dtype))
        sync()
        dist.barrier()
        _reset_counts()
        t0 = time.perf_counter()
        perm, table = None, None
        if name in ("pdgetrf", "pdpotrf"):
            f = (pdgetrf if name == "pdgetrf" else pdpotrf)(M)
            desc, F, perm = f.desc, f.data, f.perm
            G = None
        else:
            grid = grids[shape]
            desc = BlockCyclic.create(m, m, vv, grid)
            G = distribute(M, desc)
            if name == "lu_25d_profiled":
                profiler.enable(True)
                profiler.PC()
                F, perm = lu_25d_profiled(G, desc, "tournament", precision)
                sync()
                table = {k: (c.calls, c.wall) for k, c in
                         profiler._GLOBAL.root.children.items()}
                report = profiler._GLOBAL.report()
                profiler.enable(False)
                profiler.PC()
            elif algorithm == "lu":
                F, perm = lu_25d(G, desc, "tournament", precision, unroll)
            elif algorithm == "clu":
                F, perm = clu_25d(G, desc)
            else:
                F = cholesky_25d(G, desc, precision, unroll)
        sync()
        t1 = time.perf_counter()
        entry = {"counts": _counts(), "grid": str(desc.grid), "v": desc.v}
        if G is None:
            G = distribute(M, desc)           # the gate's input blocks
            sync()
        tg = time.perf_counter()
        if perm is None:
            gate = cholesky_residual_dist(G, F, desc)
        else:
            gate = lu_residual_dist(G, F, perm, desc)
        sync()
        t2 = time.perf_counter()
        if name in ("pdgetrf", "pdpotrf"):
            dense = f.dense()
        else:
            dense = undistribute(F, desc)
        sync()
        t3 = time.perf_counter()
        entry.update({"ms": (t1 - t0 + t3 - t2) * 1e3, "factor_ms":
                      (t1 - t0) * 1e3, "gate_s": t2 - tg, "gate": gate})
        if table is not None:
            entry["table"] = table
            entry["report"] = report
        if name in ("lu_25d_profiled", "lu_25d fori"):
            kept[name] = (F, perm)
        if dense is not None:
            entry["on_card"] = dense.is_cuda
            if perm is None:
                entry["residual"] = cholesky_residual_blocked(
                    M, dense[:m, :m])
            else:
                entry["on_card"] &= perm.is_cuda
                entry["permutation"] = torch.equal(
                    torch.sort(perm).values,
                    torch.arange(desc.M, device="cuda"))
                entry["residual"] = lu_residual_blocked(M, dense, perm)
            if name == "pdgetrf":
                entry["ipiv_walk"] = bool(np.array_equal(
                    _ipiv_walk(f.ipiv(), desc.M), perm.cpu().numpy()))
        out[name] = entry
        del F, G, dense
    F1, p1 = kept["lu_25d_profiled"]
    F2, p2 = kept["lu_25d fori"]
    out["profiled_equal"] = bool(torch.equal(F1, F2) and torch.equal(p1, p2))
    del kept, F1, F2, p1, p2

    # the retile round trip: v -> 2v -> v on DIST_GRID
    A = inputs[n][0]
    grid = grids[DIST_GRID]
    src = BlockCyclic.create(n, n, v, grid)
    dst = BlockCyclic.create(n, n, 2 * v, grid)
    G = distribute(A, src)
    sync()
    dist.barrier()
    t0 = time.perf_counter()
    G2 = retile(G, src, dst)
    sync()
    t1 = time.perf_counter()
    back = retile(G2, dst, src)
    sync()
    t2 = time.perf_counter()
    out["retile"] = {"there_s": t1 - t0, "back_s": t2 - t1,
                     "equal": bool(torch.equal(back, G)
                                   and torch.equal(G2, distribute(A, dst)))}
    del inputs, A, G, G2, back
    torch.cuda.empty_cache()

    # 'full' pivoting is exact partial pivoting: its pivots must be the
    # single-device port's
    n2, v2 = check
    g = torch.Generator(device="cuda").manual_seed(44)
    A2 = torch.randn(n2, n2, generator=g, device="cuda")
    F2, p2 = plu(A2, grid, v2, "full", "highest")
    if grid.rank == 0:
        Fs, ps = lu_factor(A2, v=v2, precision="highest", scheme="crout")
        out["full"] = {
            "equal": torch.equal(p2, ps),
            "agree": float((p2 == ps).double().mean()),
            "max_rel_diff": float((F2 - Fs).abs().max() / Fs.abs().max()),
            "residual": lu_residual_blocked(A2, F2, p2)}
    out["jax"] = "jax" in sys.modules
    return out


def phase_dist(smi: str, n: int = DIST_N, v: int = DIST_V,
               check=DIST_CHECK):
    """The distributed paths: DIST_GRID's 8 ranks as 8 processes of one
    gloo world on this one card (kernels built already, so the ranks only
    load them), each running every factorization of `_dist_runs`; every
    rank's launches held to the step loops' counts, every distributed
    gate to its bound and to the gathered factor's residual. Returns each
    run's launches summed over the ranks."""
    from conflux_tpu_torch.launch import run_ranks
    from conflux_tpu_torch.ops import cuda_panel

    import torch

    # the earlier phases' cached blocks go back to the card for the ranks
    torch.cuda.empty_cache()
    P = DIST_GRID[0] * DIST_GRID[1] * DIST_GRID[2]
    t0 = time.perf_counter()
    ranks = run_ranks(P, _dist_rank, n, v, check, backend="gloo",
                      device="cuda", timeout=DIST_TIMEOUT)
    wall = time.perf_counter() - t0
    sums = {}
    for (name, algorithm, shape, m, vv, precision, unroll,
         what, dtype) in _dist_runs(n, v):
        shape, vv, auto = _run_shape(name, algorithm, shape, m, vv)
        variant = {None: auto, False: "fori"}.get(unroll, unroll)
        program = (algorithm if algorithm in ("cholesky", "clu")
                   else variant)
        if program not in ("windowed", "fori", "crout", "cholesky", "clu"):
            fail(f"dist {name}: no launch count for variant {variant!r}")
        route = (cuda_panel.route_f64 if dtype == "float64"
                 else cuda_panel.route)
        want = _dist_want(program, route, m, vv, shape, precision, dtype)
        bound = DIST_GATES[(dtype, algorithm)]
        for r in ranks:
            bad = {k: (r[name]["counts"][k], w) for k, w in want.items()
                   if r[name]["counts"][k] != w}
            if bad:
                fail(f"dist {name} rank {r['rank']}: launches (got, "
                     f"expected) {bad}")
        root = ranks[0][name]
        grid = "x".join(map(str, shape))
        if root["grid"] != grid or root["v"] != vv:
            fail(f"dist {name}: ran on {root['grid']} v={root['v']}, "
                 f"expected {grid} v={vv}")
        if not root["on_card"]:
            fail(f"dist {name}: the result left the card")
        if algorithm != "cholesky" and not root["permutation"]:
            fail(f"dist {name}: perm is not a permutation")
        if not root["residual"] <= bound:
            fail(f"dist {name}: residual {root['residual']} > {bound}")
        gates = {r[name]["gate"] for r in ranks}
        gate = root["gate"]
        if len(gates) != 1:
            fail(f"dist {name}: the ranks' distributed gates differ: {gates}")
        if not (gate <= bound
                and root["residual"] / GATE_RATIO < gate
                < root["residual"] * GATE_RATIO):
            fail(f"dist {name}: distributed gate {gate} against the "
                 f"gathered factor's {root['residual']} (bound "
                 f"{bound}, within {GATE_RATIO}x)")
        if name == "pdgetrf" and not root["ipiv_walk"]:
            fail("dist pdgetrf: ipiv's swaps do not give perm")
        ms = [r[name]["ms"] for r in ranks]
        sums[f"dist {name}"] = {k: sum(r[name]["counts"][k] for r in ranks)
                                for k in want}
        print(f"dist {name} {grid} N={m} v={vv} '{precision}' ({what}: "
              f"{variant}), 8 ranks on one card, gloo through the host: "
              f"not a multi-GPU time, on {smi}: wall rank 0 "
              f"{ms[0]:.1f} ms, max over ranks {max(ms):.1f} ms "
              f"(distribute, factorization and the gather to rank 0; the "
              f"factorization {root['factor_ms']:.1f} ms on rank 0), "
              f"distributed gate {gate:.3e} (bound {bound:.0e}) in "
              f"{root['gate_s']:.2f} s, gathered residual "
              f"{root['residual']:.3e}, launches per rank {{K1: "
              f"{want['rank1_panel']} (" + ", ".join(
                  f"{r} {want['rank1_panel ' + r]}" for r in K1_ROUTES)
              + f"), K1 f64: {want['rank1_panel_f64']} (" + ", ".join(
                  f"{r} {want['rank1_panel_f64 ' + r]}" for r in K1_ROUTES)
              + f"), K3: "
              f"{want['schur_update']}}} as derived from the step loop on "
              "every rank")
    prof, fori = (ranks[0][k] for k in ("lu_25d_profiled", "lu_25d fori"))
    if not all(r["profiled_equal"] for r in ranks):
        fail("dist lu_25d_profiled: F or pivots differ from lu_25d("
             "unroll=False)'s")
    if prof["counts"] != fori["counts"]:
        fail(f"dist lu_25d_profiled: launches {prof['counts']} differ from "
             f"the unprofiled run's {fori['counts']}")
    names = ("step0_reduce", "step1_pivot", "step23_rows", "step45_trsm",
             "step6_update")
    Nt = (n // 2) // v
    if (sorted(prof["table"]) != sorted(names)
            or any(prof["table"][k][0] != Nt for k in names)):
        fail(f"dist lu_25d_profiled: region table {prof['table']}")
    print(f"dist lu_25d_profiled: F and pivots bit-equal to lu_25d(unroll="
          f"False) on every rank, the same launches; rank 0's regions "
          f"(calls = Nt = {Nt}):")
    for line in prof["report"].splitlines():
        print("  " + line)
    ret = ranks[0]["retile"]
    if not all(r["retile"]["equal"] for r in ranks):
        fail("dist retile: the round trip is not bit-equal")
    print(f"dist retile {'x'.join(map(str, DIST_GRID))} N={n} v={v} -> "
          f"v={2 * v} and back: bit-equal on every rank (and equal "
          f"to distribute at v={2 * v}), rank 0 "
          f"{ret['there_s']:.2f} s there, {ret['back_s']:.2f} s back")
    full = ranks[0]["full"]
    grid = "x".join(map(str, DIST_GRID))
    print(f"dist 'full' pivoting {grid} N={check[0]} v={check[1]} 'highest': "
          f"pivots equal to the single-device lu_factor's {full['equal']} "
          f"(agree {full['agree']:.4f}), max|F - F_single| / max|F_single| "
          f"{full['max_rel_diff']:.3e}, residual {full['residual']:.3e}")
    if not full["equal"]:
        fail("dist 'full' pivots differ from the single-device port's")
    if not full["residual"] <= RESIDUAL_GATE:
        fail(f"dist 'full' residual {full['residual']}")
    if any(r["jax"] for r in ranks):
        fail("a rank imported jax")
    devices = sorted({r["device"] for r in ranks})
    print(f"dist phase: {P} ranks on {devices}, {wall:.1f} s in all "
          "(spawn, process groups, every run, the gates and the checks)")
    return sums


# the stepped drivers (lu/stepped.py, cholesky/stepped.py) at the size
# they exist for: an N = 65536 f32 matrix (17.2 GB) whose in-memory
# factorization (about four copies at its peak) an 80 GB card cannot
# hold; v = 1024, the drivers' default; N cut to STEP_N_SMALL where the
# host cannot hold A, F and the input of the next run in f32; the crout
# stepped LU (two copies) at the main paths' N
STEP_N, STEP_N_SMALL, STEP_V = 65536, 49152, 1024
STEP_CROUT_N = N
# the flat f32 run's device peak, in copies of A: one working buffer, the
# step's temporaries and one row block of the stream to the host
STEP_PEAK = 1.3
# bf16 storage's bound on ||PA - LU||_F / ||A||_F (PERF.md §2, the JAX
# package's tests/test_single_device.py:271-290)
STEP_BF16_GATE = 0.05


def _loop_want(path: str, n: int, v: int) -> dict:
    """Each counter's launches in one n, v run of a stepped path (or of
    'crout', the main path): `loop_launches`, with K1's per route on this
    card and K3's and K2's on their wgmma route."""
    from conflux_tpu_torch.ops import cuda_panel

    path = path.replace(" bf16", "")
    want = {name: 0 for name in _counters()}
    want.update(loop_launches(path, n, v))
    blocks = k1_blocks(path, n, v)
    taken = [cuda_panel.route(*b) for b in blocks]
    for r in K1_ROUTES:
        want[f"rank1_panel {r}"] = taken.count(r)
    want["rank1_panel grid clustered"] = k1_clustered(
        blocks, cuda_panel.route, cuda_panel.grid_cluster)
    want["schur_update wgmma"] = want["schur_update"]
    want["sub_matmul_bigk wgmma"] = want["sub_matmul_bigk"]
    want.update({f"sub_matmul_bigk_bf16 {r}": 0 for r in BF16_COUNTS})
    if want["sub_matmul_bigk_bf16"]:
        want.update(BF16_ROUTE_LAUNCHES[path])
    want["lower_solve"] = lower_solve_launches(path, n, v)
    return want


def _stepped_run(fn, *args, **kwargs):
    """One run of fn on a card cleared of cached blocks: (ms between two
    CUDA events around the call, its result, its launches, the device's
    peak memory)."""
    import torch

    from conflux_tpu_torch.timing import timed_run

    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    ms, out = timed_run(lambda: fn(*args, **kwargs))
    counts = _counts()
    return ms, out, counts, torch.cuda.max_memory_allocated()


def _need_native(phase: str):
    """Fail unless the native host library is loaded: without it
    `io.random_matrix` fills a matrix of 2^22 entries or more from numpy,
    not the JAX package's (native) matrix."""
    from conflux_tpu_torch import native

    if not native.available():
        fail(f"{phase}: the native host library did not build or load, so "
             "random_matrix would not fill the JAX package's matrix")
    print(f"{phase}: native host library loaded, {native.num_threads()} "
          "OpenMP threads")


def _host_perm_ok(perm, n: int) -> bool:
    return bool(np.array_equal(np.sort(np.asarray(perm)), np.arange(n)))


def phase_stepped(smi: str):
    """The stepped drivers, one run each: lu_factor_stepped flat in f32
    (out='host', on the native-filled random_matrix; device peak within
    STEP_PEAK copies of A) and in bf16 storage (out='device'),
    cholesky_stepped f32 (out='host', on spd_matrix) at STEP_N, and the
    crout stepped LU at STEP_CROUT_N; each with its wall, device peak
    memory and launches held to the step loop, gated by the streaming
    blocked gates on the card. Returns each run's launches."""
    import os

    import torch

    from conflux_tpu_torch.cholesky.stepped import cholesky_stepped
    from conflux_tpu_torch.io import random_matrix, spd_matrix
    from conflux_tpu_torch.lu.stepped import lu_factor_stepped
    from conflux_tpu_torch.validation import cholesky_residual_blocked, \
        lu_residual_blocked

    mem = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    # A and F in f32, and the next run's input beside them
    n = STEP_N if mem >= 3 * STEP_N ** 2 * 4 else STEP_N_SMALL
    print(f"host MemTotal {mem / 2 ** 30:.1f} GiB: the stepped runs take "
          f"N={n}" + ("" if n == STEP_N else f" (cut from {STEP_N}: the "
                      "host cannot hold A and F in f32)"))
    out = {}

    def report(tag, n, ms, peak, copies, counts, gate, gate_s, bound,
               flops, what):
        path = tag.split(" out=")[0]
        want = _loop_want(path, n, STEP_V)
        _expect([counts], want, f"{tag} N={n}")
        out[path] = counts
        print(f"{tag} N={n} v={STEP_V} 'high' on {smi}: wall {ms:.1f} ms "
              f"({what}), {flops / (ms * 1e-3) / 1e9:.1f} GFLOP/s, device "
              f"peak {peak / 2 ** 30:.3f} GiB = {copies:.3f} copies of A, "
              f"launches {{K1: {want['rank1_panel']} (" + ", ".join(
                  f"{r} {want['rank1_panel ' + r]}" for r in K1_ROUTES)
              + f"), K3: {want['schur_update']}, K2: "
              f"{want['sub_matmul_bigk']}}} as derived from the step loop, "
              f"residual {gate:.3e} (bound {bound:.3e}) by the streaming "
              f"gate in {gate_s:.1f} s")
        if not gate <= bound:
            fail(f"{tag} N={n}: residual {gate} over {bound}")

    lu_flops = 2.0 / 3.0 * n ** 3
    _need_native("stepped")
    t0 = time.perf_counter()
    A = random_matrix(n, n)
    print(f"stepped: random_matrix({n}, {n}) {A.dtype} in "
          f"{time.perf_counter() - t0:.1f} s (native fill)")
    ms, (F, perm), counts, peak = _stepped_run(
        lu_factor_stepped, A, STEP_V, "high", out="host")
    copies = peak / A.nbytes
    if not (isinstance(F, np.ndarray) and F.shape == A.shape
            and F.dtype == np.float32 and _host_perm_ok(perm, n)):
        fail(f"stepped flat: F {type(F)} {getattr(F, 'shape', None)} or "
             "perm is not a permutation")
    if not copies <= STEP_PEAK:
        fail(f"stepped flat: device peak {peak} B = {copies:.3f} copies "
             f"of A, over {STEP_PEAK}")
    t0 = time.perf_counter()
    gate = lu_residual_blocked(A, F, perm)
    report("stepped flat out=host", n, ms, peak, copies, counts, gate,
           time.perf_counter() - t0, RESIDUAL_GATE, lu_flops,
           "upload, factorization and the host stream of F")
    del F, perm

    Ab = torch.from_numpy(A).to(torch.bfloat16)     # the factored matrix
    del A
    ms, (F, perm), counts, peak = _stepped_run(
        lu_factor_stepped, Ab, STEP_V, "high", out="device")
    if not (F.is_cuda and F.dtype == torch.bfloat16
            and _host_perm_ok(perm.cpu(), n)):
        fail(f"stepped flat bf16: F {F.dtype} on {F.device} or perm is "
             "not a permutation")
    t0 = time.perf_counter()
    gate = lu_residual_blocked(Ab, F, perm) * n       # un-normalised
    report("stepped flat bf16 out=device", n, ms, peak, peak / Ab.nbytes,
           counts, gate, time.perf_counter() - t0, STEP_BF16_GATE,
           lu_flops, "upload, factorization and F = R[perm] on the card; "
           "the residual is ||PA - LU||_F / ||A||_F")
    del Ab, F, perm

    S = spd_matrix(n)
    ms, L, counts, peak = _stepped_run(
        cholesky_stepped, S, STEP_V, "high", out="host")
    if not (isinstance(L, np.ndarray) and L.shape == S.shape):
        fail(f"stepped cholesky: L {type(L)}")
    for r0 in range(0, n, 8192):
        if np.triu(L[r0:r0 + 8192], r0 + 1).any():
            fail("stepped cholesky: L is not lower triangular")
    t0 = time.perf_counter()
    gate = cholesky_residual_blocked(S, L)
    report("stepped cholesky out=host", n, ms, peak, peak / S.nbytes,
           counts, gate, time.perf_counter() - t0, RESIDUAL_GATE,
           n ** 3 / 3.0, "upload, factorization, in-place tril and the "
           "host stream of L")
    del S, L

    nc = STEP_CROUT_N
    A = random_matrix(nc, nc)
    ms, (F, perm), counts, peak = _stepped_run(
        lu_factor_stepped, A, STEP_V, "high", out="device", scheme="crout")
    if not (F.is_cuda and _host_perm_ok(perm.cpu(), nc)):
        fail("stepped crout: F left the card or perm is not a permutation")
    t0 = time.perf_counter()
    gate = lu_residual_blocked(A, F, perm)
    report("stepped crout out=device", nc, ms, peak, peak / A.nbytes,
           counts, gate, time.perf_counter() - t0, RESIDUAL_GATE,
           2.0 / 3.0 * nc ** 3, "upload and factorization")
    del A, F, perm
    torch.cuda.empty_cache()
    return out


# the front ends, driven through their main() as a user runs them: the
# LU miniapp on the main path (in this process, 'high') and on a (2, 2, 2)
# grid of 8 ranks it starts (gloo, on this card), the Cholesky miniapp on
# (2, 2, 2), a profiled LU at N = 4096, the Cholesky helper's files, and
# the sweep of configs/params_example.ini with its csv in a temporary
# directory
# (app, flags, main path): the main path's run, in this process, has its
# launches held to those of the scheme auto_scheme names for its padded N
CLI_RUNS = (
    ("conflux_miniapp", "-N 32768 -b 1536 -p 1x1x1 -r 2 --validate "
                        "--precision high", True),
    ("conflux_miniapp", "-N 16384 -b 512 -p 2x2x2 -r 1 --validate", False),
    ("cholesky_miniapp", "-N 16384 -v 512 -g 2x2x2 -r 1 --validate", False),
    ("conflux_miniapp", "-N 4096 -b 256 -p 1x1x1 -r 1 --profile", False),
)
CLI_HELPER_N = 2048


def _captured(fn, *args):
    """(fn(*args), its standard output), the output echoed indented."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(*args)
    text = buf.getvalue()
    for line in text.splitlines():
        print("  | " + line)
    return rc, text


def _result_lines(text: str, tag: str):
    """The `_result_` lines of a run, each split into its 10 fields."""
    rows = [line.split(" ", 1)[1].split(",") for line in text.splitlines()
            if line.startswith("_result_ ")]
    if not rows or any(len(r) != 10 for r in rows):
        fail(f"cli {tag}: _result_ lines {rows}")
    return rows


def phase_cli(smi: str):
    """CLI_RUNS through each miniapp's main(); every `_result_` line's
    fields checked (algorithm, library, N, N_base, P, grid, unit, type,
    value, v), every time > 0, one time line per repetition, the residual
    <= 1e-6; the in-process main-path run's launches held to 3
    factorizations (warm-up and two repetitions). Then the Cholesky
    helper and the sweep. Returns that run's launches."""
    import configparser
    import csv
    import tempfile

    import torch

    from conflux_tpu_torch.bench import plots
    from conflux_tpu_torch.cholesky.single import cholesky
    from conflux_tpu_torch.cli import cholesky_helper, cholesky_miniapp, \
        conflux_miniapp, sweep
    from conflux_tpu_torch.io import load_matrix, save_matrix
    from conflux_tpu_torch.lu.single import auto_scheme

    mains = {"conflux_miniapp": conflux_miniapp.main,
             "cholesky_miniapp": cholesky_miniapp.main}
    _need_native("cli")
    out = {}
    for app, flags, main_path in CLI_RUNS:
        argv = flags.split()
        opt = dict(zip(argv[::2], argv[1::2]))
        n = int(opt["-N"])
        grid = opt.get("-p") or opt["-g"]
        P = int(np.prod([int(x) for x in grid.split("x")]))
        v = opt.get("-b") or opt["-v"]
        reps = int(opt["-r"])
        torch.cuda.empty_cache()
        _reset_counts()
        t0 = time.perf_counter()
        rc, text = _captured(mains[app], argv)
        wall = time.perf_counter() - t0
        counts = _counts()
        tag = f"{app} {flags}"
        rows = _result_lines(text, tag)
        lib = "conflux-tpu" if app == "conflux_miniapp" else "psychol"
        alg = "lu" if app == "conflux_miniapp" else "cholesky"
        for r in rows:
            want = [alg, lib, str(n), str(n), str(P), grid]
            if r[:6] != want or r[7] != "strong" or r[9] != v:
                fail(f"cli {tag}: fields {r}, expected {want} ... strong "
                     f"... {v}")
        times = [float(r[8]) for r in rows if r[6] == "time"]
        res = [float(r[8]) for r in rows if r[6] == "residual"]
        if rc != 0 or len(times) != reps or not all(t > 0 for t in times):
            fail(f"cli {tag}: rc {rc}, times {times}")
        if ("--validate" in argv) != bool(res) or not all(
                x <= RESIDUAL_GATE for x in res):
            fail(f"cli {tag}: residual lines {res}")
        if "--profile" in argv and "lu_profiled_total" not in text:
            fail(f"cli {tag}: no profiled region table")
        note = ""
        if main_path:
            # lu_25d on (1, 1, 1) runs the scheme auto_scheme names for
            # the matrix padded to a multiple of v
            # (layout.BlockCyclic.create)
            vi = int(v)
            npad = -(-n // vi) * vi
            path = auto_scheme(npad)
            want = {k: 3 * c for k, c in _loop_want(path, npad,
                                                     vi).items()}
            _expect([counts], want, f"cli {tag}")
            out["cli conflux_miniapp 1x1x1"] = counts
            note = (f", launches of its 3 factorizations (warm-up and 2 "
                    f"repetitions, N padded to {npad}) K1 "
                    f"{counts['rank1_panel']}, K2 "
                    f"{counts['sub_matmul_bigk']} as derived for "
                    f"auto_scheme({npad}) = {path!r}")
        print(f"cli {tag} on {smi}: rc 0, times ms {times}, residual "
              f"{res}, {wall:.1f} s of wall in all{note}")

    with tempfile.TemporaryDirectory() as tmp:
        nh = CLI_HELPER_N
        rc, _ = _captured(cholesky_helper.main,
                          ["--generate", str(nh), "--dir", tmp])
        A = torch.from_numpy(load_matrix(f"{tmp}/input_{nh}.bin", nh)).cuda()
        save_matrix(f"{tmp}/output_{nh}.bin", cholesky(A, 256))
        rc2, text = _captured(cholesky_helper.main,
                              ["--compare", str(nh), "--dir", tmp])
        if rc or rc2 or "OK" not in text:
            fail(f"cli cholesky_helper: rc {rc} / {rc2}")
        print(f"cli cholesky_helper --generate {nh} / --compare {nh} with "
              f"the port's float64 cholesky on the card: OK")

        cfg = configparser.ConfigParser()
        cfg.read("configs/params_example.ini")
        csv_path = f"{tmp}/benchmarks.csv"
        for section in cfg.sections():
            cfg[section]["csv"] = csv_path
        ini = f"{tmp}/params_example.ini"
        with open(ini, "w") as f:
            cfg.write(f)
        t0 = time.perf_counter()
        rc, text = _captured(sweep.main, [ini])
        wall = time.perf_counter() - t0
        with open(csv_path) as f:
            rows = list(csv.reader(f))
        want = sum(len(s.get("sizes").split(",")) * s.getint("reps")
                   for s in (cfg[x] for x in cfg.sections()))
        if rc or rows[0][:6] != ["algorithm", "library", "N", "N_base", "P",
                                 "grid"] or len(rows) != 1 + want:
            fail(f"cli sweep: rc {rc}, {len(rows) - 1} rows, expected "
                 f"{want}")
        if not all(float(r[8]) > 0 for r in rows[1:]):
            fail("cli sweep: a time <= 0")
        summary = plots.summarize(plots.load(csv_path))
        print(f"cli sweep configs/params_example.ini on {smi}: {want} rows "
              f"in {wall:.1f} s, plots.summarize: {len(summary)} series")
    return out


def _pick(table, **want):
    return next(r for r in table if all(r[k] == v for k, v in want.items()))


# K1's and K1 in double's per route and path, and the bf16 entry's per
# route and bf16 path, set once the card is known
ROUTE_LAUNCHES = {}
ROUTE_LAUNCHES_F64 = {}
BF16_ROUTE_LAUNCHES = {}


def _walled(label: str, phase, *args):
    """phase(*args), its wall printed."""
    t0 = time.perf_counter()
    out = phase(*args)
    print(f"phase {label}: {time.perf_counter() - t0:.1f} s of wall")
    return out


T0 = time.perf_counter()


def main() -> int:
    smi = phase_device()
    import torch

    from conflux_tpu_torch.ops import cuda_panel

    phase_build()
    ROUTE_LAUNCHES.update(k1_route_launches(
        cuda_panel.route, grid_cluster=cuda_panel.grid_cluster))
    ROUTE_LAUNCHES_F64.update(k1_route_launches(cuda_panel.route_f64,
                                                "rank1_panel_f64"))
    from conflux_tpu_torch.ops import cuda_gemm

    BF16_ROUTE_LAUNCHES.update({
        p: bf16_route_launches(cuda_gemm.sub_matmul_bigk_bf16_route, p)
        for p in ("bf16 crout", "bf16 cholesky")})
    print(f"K2 bf16 operands: launches per factorization by route "
          f"({cuda_gemm._load_bigk().conflux_sub_matmul_bigk_bf16_clusters()}"
          f" ping-pong clusters of 4 CTAs at once): {BF16_ROUTE_LAUNCHES}")
    print(f"K1 cluster route up to m = {cuda_panel.cluster_max_m(128)} at "
          f"w = 128 and {cuda_panel.cluster_max_m(64)} at w = 64, forced "
          f"blocks on the tile route; launches per factorization by route: "
          f"{ROUTE_LAUNCHES}")
    print(f"K1 in double: cluster route up to m = "
          f"{cuda_panel.cluster_max_m_f64(128)} at w = 128 and "
          f"{cuda_panel.cluster_max_m_f64(64)} at w = 64, forced blocks on "
          f"the tile route; launches per factorization by route: "
          f"{ {p: ROUTE_LAUNCHES_F64[p] for p in ('crout', 'cholesky')} }")
    k1_rows = phase_k1()
    k1f64_rows = phase_k1_f64()
    phase_trsm()
    phase_winners_solve()
    phase_lanes()
    medium_bf16 = phase_medium_probe()
    k3_rows = phase_k3(medium_bf16)
    k2_rows = phase_k2(medium_bf16)
    k2b_rows = phase_k2_bf16()
    _reset_counts()
    k4_rows = phase_k4()
    k4_counts = _counts()
    k56_rows = phase_rows()
    phase_small()
    print(f"phase build and kernels: {time.perf_counter() - T0:.1f} s of "
          "wall")
    by_path = {"crout": _walled("crout", phase_lu_path, smi, "crout"),
               "recursive": _walled("recursive", phase_lu_path, smi,
                                    "recursive"),
               "auto": _walled("auto", phase_auto, smi),
               "flat": _walled("flat", phase_lu_path, smi, "flat"),
               "cholesky": _walled("cholesky", phase_cholesky_path, smi),
               "swap": _walled("swap", phase_lu_path, smi, "swap"),
               "split": _walled("split", phase_lu_path, smi, "split")}
    by_path.update(_walled("dtypes", phase_dtypes, smi))
    by_path.update(_walled("stepped", phase_stepped, smi))
    by_path.update(_walled("dist", phase_dist, smi))
    by_path.update(_walled("cli", phase_cli, smi))
    launches = {name: sum(c[name] for c in by_path.values())
                for name in KERNELS}
    for name, n in launches.items():
        # K4 is exempt: no path of the JAX package calls matmul_pallas
        if n == 0 and name != "matmul":
            fail(f"{name} was never launched on the main paths")
    launches["matmul"] = k4_counts["matmul"]
    if "jax" in sys.modules:
        fail("jax was imported")
    # each kernel's row at its representative main-path shape and mode
    picks = {
        "rank1_panel": ("conflux_tpu_torch/csrc/rank1_panel.cu",
                        "conflux_tpu/ops/pallas_panel.py:83",
                        _pick(k1_rows, shape=PANEL_SHAPES[0], mode="finish")),
        "schur_update": ("conflux_tpu_torch/csrc/schur_update.cu",
                         "conflux_tpu/ops/pallas_gemm.py:95",
                         _pick(k3_rows, shape="first", mode="high")),
        "sub_matmul_bigk": ("conflux_tpu_torch/csrc/bigk_gemm.cu",
                            "conflux_tpu/ops/pallas_gemm.py:151",
                            _pick(k2_rows, shape=K2_SHAPES[0][0],
                                  mode="high")),
        "matmul": ("conflux_tpu_torch/csrc/bigk_gemm.cu",
                   "conflux_tpu/ops/pallas_gemm.py:30",
                   _pick(k4_rows, shape=K4_SHAPES[0], route="float32")),
        "scatter_rows": ("conflux_tpu_torch/csrc/row_move.cu",
                         "conflux_tpu/ops/pallas_scatter.py:42",
                         _pick(k56_rows, kind="scatter", dtype="float32")),
        "gather_rows": ("conflux_tpu_torch/csrc/row_move.cu",
                        "conflux_tpu/ops/pallas_scatter.py:114",
                        _pick(k56_rows, kind="gather", rows=V, width=N,
                              dtype="float32")),
        "rank1_panel_f64": ("conflux_tpu_torch/csrc/rank1_panel_f64.cu",
                            "conflux_tpu/ops/pallas_panel.py:83",
                            _pick(k1f64_rows, shape=K1_F64_SHAPES[0][:2],
                                  mode="finish")),
        "sub_matmul_bigk_bf16": ("conflux_tpu_torch/csrc/bigk_gemm.cu",
                                 "conflux_tpu/ops/pallas_gemm.py:151",
                                 _pick(k2b_rows, shape=K2_BF16_SHAPES[0][0],
                                       mode="bf16")),
    }
    kernels = []
    for name in KERNELS:
        source, replaces, row = picks[name]
        entry = {"name": name, "route": "cuda", "source": source,
                 "replaces": replaces, "launches": launches[name],
                 "launches_by_path": {p: c[name] for p, c in by_path.items()}}
        if name == "matmul":
            entry["launches_from"] = ("its own phase: no path of the JAX "
                                      "package calls matmul_pallas")
            wgmma = k4_counts["matmul wgmma"]
            mma = k4_counts["matmul mma.sync"]
            entry["launches_by_route"] = {
                "wgmma": wgmma, "mma.sync": mma,
                "f32": k4_counts["matmul"] - wgmma - mma}
        if name in ("rank1_panel", "rank1_panel_f64"):
            entry["launches_by_route"] = {
                r: sum(c[f"{name} {r}"] for c in by_path.values())
                for r in K1_ROUTES}
        if name in ("schur_update", "sub_matmul_bigk"):
            entry["launches_by_route"] = {
                "wgmma": sum(c[name + " wgmma"] for c in by_path.values())}
        if name == "sub_matmul_bigk_bf16":
            entry["launches_by_route"] = {
                r: sum(c[f"{name} {r}"] for c in by_path.values())
                for r in BF16_ROUTES}
            entry["b_read_k_major"] = sum(c[f"{name} k-major"]
                                          for c in by_path.values())
            entry["operand_copies"] = sum(c[f"{name} copies"]
                                          for c in by_path.values())
            entry["library_call"] = k2b_rows[0]["library_call"]
        if name in ("scatter_rows", "gather_rows"):
            bulk = sum(c[name + " bulk"] for c in by_path.values())
            entry["launches_by_route"] = {"bulk": bulk,
                                          "words": launches[name] - bulk}
        keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms")
        entry.update({k: row[k] for k in keys})
        if name == "rank1_panel_f64":
            # each double route at each of its shapes
            entry["by_route"] = {
                r: [{"shape": list(x["shape"]), "mode": x["mode"],
                     **{k: x[k] for k in keys}}
                    for x in k1f64_rows if x["route"] == r]
                for r in K1_ROUTES}
        kernels.append(entry)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
