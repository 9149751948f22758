#!/usr/bin/env python3
"""Run the PyTorch port's main paths once on one CUDA card, and check them.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

  1. device: a CUDA card is required; print its name and power limit, the
     torch version, and assert that fp32 matrix products stay IEEE fp32;
  2. build: build (or load) every kernel from csrc/, one nvcc per source,
     started together: K1, the rank-1 panel kernel (rank1_panel.cu); K3,
     the fused trailing update (schur_update.cu); K2, the big-K R - A@B,
     and K4, the plain GEMM (bigk_gemm.cu); K5 and K6, the row scatter and
     gather (row_move.cu);
  3. K1 vs plain: K1 against its plain PyTorch version on the same CUDA
     inputs, in unforced, forced and finish modes, at the main path's
     block shapes plus a ragged one with a masked lane, forced at the
     flat and Cholesky paths' [128, 1536] and [64, 1536] tile blocks with
     first pivots j0 > 0 (the tile route), and at the cluster route's
     widest block and 128 lanes more (the grid route) at w = 128 and 64
     in all three modes (forced ones on the tile route); every call
     checked against the route counter it must move;
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
     calls beside the whole call's;
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
  9. crout main path: lu_factor(A, v=1536, precision='high') at N=32768
     f32 (one warm-up, then timed runs), every kernel's launches per
     factorization, peak device memory, and the blocked residual;
 10. flat path: the same with scheme='flat';
 11. Cholesky path: cholesky(A, v=1536, precision='high') at N=32768;
 12. swap and split paths: crout with compaction='swap' and 'split'.

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
into the cluster, grid and tile routes, K3's and K2's into their one route
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
# K1 launches per N=32768 v=1536 factorization (128-wide blocks): crout
# runs 21 panels of 1536 columns at 12 blocks, then one of 512 at 4; flat
# runs each panel twice (the unforced search and the forced refactor of
# the pivot rows); Cholesky's lu_nopivot runs 64-wide blocks
K1_CROUT = (N // V) * (V // 128) + (N % V) // 128
K1_FLAT = 2 * K1_CROUT
K1_CHOLESKY = (N // V) * (V // 64) + (N % V) // 64
# K3 launches per flat factorization: one per step with k + w < n
STEPS = -(-N // V)         # 22: 21 panels of 1536 columns, one of 512
K3_FLAT = STEPS - 1
# split and swap run each panel through factor_panel: the unforced search,
# then the forced refactor of the pivot rows, as on flat
K1_COMPACT = K1_FLAT
# K2 on every crout compaction ('gather', split and swap): one panel
# update per step with k > 0 (21) and one pivot-row refresh per step with
# k > 0 and k + w < n (20)
K2_COMPACT = (STEPS - 1) + (STEPS - 2)
# K2 on Cholesky: one panel update per step with k > 0
K2_CHOLESKY = STEPS - 1
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
           "scatter_rows", "gather_rows")
# launches per factorization of each path; a kernel left out runs 0 times
PATH_LAUNCHES = {
    "crout": {"rank1_panel": K1_CROUT, "sub_matmul_bigk": K2_COMPACT},
    "flat": {"rank1_panel": K1_FLAT, "schur_update": K3_FLAT},
    "cholesky": {"rank1_panel": K1_CHOLESKY,
                 "sub_matmul_bigk": K2_CHOLESKY},
    "swap": {"rank1_panel": K1_COMPACT, "sub_matmul_bigk": K2_COMPACT,
             "scatter_rows": K5_SWAP, "gather_rows": K6_SWAP},
    "split": {"rank1_panel": K1_COMPACT, "sub_matmul_bigk": K2_COMPACT,
              "gather_rows": K6_SPLIT},
}
def k1_blocks(path: str):
    """(w, m, forced) of every K1 block of one N, V factorization of
    `path`, from its step loop: step k factors a panel of w = min(V, N - k)
    columns over the m = N - k live rows in 128-wide blocks; flat, swap
    and split then refactor the w gathered pivot rows, forced, in [128, w]
    blocks; Cholesky factors each [w, w] diagonal tile, forced, in [64, w]
    blocks."""
    blocks = []
    for k in range(0, N, V):
        w = min(V, N - k)
        if path == "cholesky":
            blocks += [(64, w, True)] * (w // 64)
            continue
        blocks += [(128, N - k, False)] * (w // 128)
        if path != "crout":
            blocks += [(128, w, True)] * (w // 128)
    return blocks


K1_ROUTES = ("cluster", "grid", "tile")


def k1_route_launches(route) -> dict:
    """K1's launches per factorization of each path on each route, where
    route(w, m, forced) names the route a block takes on this card."""
    out = {}
    for path in PATH_LAUNCHES:
        blocks = k1_blocks(path)
        if len(blocks) != PATH_LAUNCHES[path]["rank1_panel"]:
            fail(f"{path}: {len(blocks)} K1 blocks from the step loop, "
                 f"{PATH_LAUNCHES[path]['rank1_panel']} expected")
        taken = [route(*b) for b in blocks]
        out[path] = {f"rank1_panel {r}": taken.count(r) for r in K1_ROUTES}
    return out


# the card's published peaks (NVIDIA H100 SXM data sheet, dense) for the
# bound_ms of each kernel: device memory, bf16 tensor cores, fp32 FMA
HBM_BYTES_S = 3.35e12
BF16_FLOP_S = 989e12
FP32_FLOP_S = 67e12
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
# the one at step k = 15360, and a ragged one
K3_SHAPES = (("first", 32768, 32768, 1536, 1536, 32768),
             ("mid", 17408, 32768, 1536, 16896, 32768),
             ("ragged", 1000, 1040, 200, 37, 1000))
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
# K4 (m, k, n): experiments/prof_pallas_gemm.py's shapes; the gate is K3's
K4_SHAPES = ((16384, 512, 16384), (8192, 1024, 8192), (8192, 8192, 8192))
# K5/K6: swap's push-up of V rows into an [N, N] R, and the gathers of V
# rows and of the main path's first compaction (N - V of N rows)
ROW_MOVES = (("scatter", V), ("gather", V), ("gather", N - V))
# the split path's narrow panel gather T[origin, k:k+w] at k = V: rows of
# V f32 (6 KB) with row stride N
PANEL_SLICE = (V, 2 * V)


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


SOURCES = ("rank1_panel", "schur_update", "bigk_gemm", "row_move")


def phase_build():
    from conflux_tpu_torch.ops import _build, cuda_gemm, cuda_panel, \
        cuda_scatter

    t0 = time.perf_counter()
    _build.build(SOURCES)
    cuda_panel._load()
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
          f"{cuda_gemm._load_bigk().conflux_sub_matmul_bigk_smem_bytes()} "
          f"(rank1_panel: sized per call, up to the card's limit)")


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
    counters = ("LAUNCHES", "LAUNCHES_CLUSTER", "LAUNCHES_GRID",
                "LAUNCHES_TILE")
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
        moved = tuple(getattr(cuda_panel, c) - b
                      for c, b in zip(counters, before))
        if moved != (1,) + tuple(int(route == r) for r in K1_ROUTES):
            fail(f"K1 [{w}, {m}] {mode}: route counters moved {moved}, "
                 f"expected the {route} route")
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
    from conflux_tpu_torch.ops import cuda_gemm, cuda_panel, cuda_scatter

    return {"rank1_panel": (cuda_panel, "LAUNCHES"),
            "schur_update": (cuda_gemm, "SCHUR_UPDATE_LAUNCHES"),
            "sub_matmul_bigk": (cuda_gemm, "SUB_MATMUL_BIGK_LAUNCHES"),
            "matmul": (cuda_gemm, "MATMUL_LAUNCHES"),
            "scatter_rows": (cuda_scatter, "SCATTER_ROWS_LAUNCHES"),
            "gather_rows": (cuda_scatter, "GATHER_ROWS_LAUNCHES"),
            # routes, counted apart
            "rank1_panel cluster": (cuda_panel, "LAUNCHES_CLUSTER"),
            "rank1_panel grid": (cuda_panel, "LAUNCHES_GRID"),
            "rank1_panel tile": (cuda_panel, "LAUNCHES_TILE"),
            "schur_update wgmma": (cuda_gemm, "SCHUR_UPDATE_WGMMA_LAUNCHES"),
            "sub_matmul_bigk wgmma": (cuda_gemm,
                                      "SUB_MATMUL_BIGK_WGMMA_LAUNCHES"),
            "matmul wgmma": (cuda_gemm, "MATMUL_WGMMA_LAUNCHES"),
            "matmul mma.sync": (cuda_gemm, "MATMUL_MMA_SYNC_LAUNCHES"),
            "scatter_rows bulk": (cuda_scatter,
                                  "SCATTER_ROWS_BULK_LAUNCHES"),
            "gather_rows bulk": (cuda_scatter, "GATHER_ROWS_BULK_LAUNCHES")}


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
    """Launches per factorization of `path`: each kernel's, K1's per route
    (ROUTE_LAUNCHES, derived from the step loop once the card's cluster
    route is known) and K3's and K2's on their wgmma route."""
    want = {k: PATH_LAUNCHES[path].get(k, 0) for k in KERNELS}
    want.update(ROUTE_LAUNCHES[path])
    want["schur_update wgmma"] = want["schur_update"]
    want["sub_matmul_bigk wgmma"] = want["sub_matmul_bigk"]
    return want


def _expect(per_run, want: dict, tag: str):
    for name, n in want.items():
        got = [c[name] for c in per_run]
        if any(c != n for c in got):
            fail(f"{tag}: {name} launches per factorization {got}, "
                 f"expected {n}")


def phase_lu_path(smi: str, path: str):
    """One LU path: 'crout' and 'flat' by scheme, 'swap' and 'split' as
    crout's compactions."""
    import torch

    from conflux_tpu_torch.lu.single import lu_factor

    scheme = "flat" if path == "flat" else "crout"
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
    med = statistics.median(times)
    res = _check_factor(A, F, perm, f"{path} N={N} high")
    print(f"{path} path N={N} v={V} 'high' on {smi}: times ms "
          f"{[round(t, 3) for t in times]}, median {med:.3f} ms, "
          f"{2.0 / 3.0 * N ** 3 / (med * 1e-3) / 1e9:.1f} GFLOP/s, "
          f"peak memory {peak / 2 ** 30:.3f} GiB, launches per "
          f"factorization {per_run[-1]}, lu_residual_blocked {res:.3e}")
    return counts


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


def _pick(table, **want):
    return next(r for r in table if all(r[k] == v for k, v in want.items()))


ROUTE_LAUNCHES = {}     # K1's per route and path, set once the card is known


def main() -> int:
    smi = phase_device()
    import torch

    from conflux_tpu_torch.ops import cuda_panel

    phase_build()
    ROUTE_LAUNCHES.update(k1_route_launches(cuda_panel.route))
    print(f"K1 cluster route up to m = {cuda_panel.cluster_max_m(128)} at "
          f"w = 128 and {cuda_panel.cluster_max_m(64)} at w = 64, forced "
          f"blocks on the tile route; launches per factorization by route: "
          f"{ROUTE_LAUNCHES}")
    k1_rows = phase_k1()
    medium_bf16 = phase_medium_probe()
    k3_rows = phase_k3(medium_bf16)
    k2_rows = phase_k2(medium_bf16)
    _reset_counts()
    k4_rows = phase_k4()
    k4_counts = _counts()
    k56_rows = phase_rows()
    phase_small()
    by_path = {"crout": phase_lu_path(smi, "crout"),
               "flat": phase_lu_path(smi, "flat"),
               "cholesky": phase_cholesky_path(smi),
               "swap": phase_lu_path(smi, "swap"),
               "split": phase_lu_path(smi, "split")}
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
        if name == "rank1_panel":
            entry["launches_by_route"] = {
                r: sum(c[f"rank1_panel {r}"] for c in by_path.values())
                for r in K1_ROUTES}
        if name in ("schur_update", "sub_matmul_bigk"):
            entry["launches_by_route"] = {
                "wgmma": sum(c[name + " wgmma"] for c in by_path.values())}
        if name in ("scatter_rows", "gather_rows"):
            bulk = sum(c[name + " bulk"] for c in by_path.values())
            entry["launches_by_route"] = {"bulk": bulk,
                                          "words": launches[name] - bulk}
        entry.update({k: row[k] for k in ("max_abs_err", "ms", "plain_ms",
                                          "bound_ms", "bound_by",
                                          "library_ms")})
        kernels.append(entry)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
