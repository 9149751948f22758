#!/usr/bin/env python3
"""Run the PyTorch port's main paths once on one CUDA card, and check them.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

  1. device: a CUDA card is required; print its name and power limit, the
     torch version, and assert that fp32 matrix products stay IEEE fp32;
  2. build: build (or load) K1, the rank-1 panel kernel, and K3, the fused
     trailing update, from csrc/, one nvcc each, started together;
  3. K1 vs plain: K1 against its plain PyTorch version on the same CUDA
     inputs, in unforced, forced and finish modes, at the main path's
     block shapes plus a ragged one with a masked lane, and forced at the
     flat and Cholesky paths' [128, 1536] and [64, 1536] tile blocks with
     first pivots j0 > 0;
  4. K3 vs plain: K3 against its plain PyTorch version on the same CUDA
     inputs, in 'high', 'bf16' and 'bf16out', at the flat LU's first and a
     mid-run trailing update and at a ragged span;
  5. small end to end: crout, flat and recursive LU at N=2048 in 'high'
     and 'highest', Cholesky flat and recursive, and the two solves;
  6. crout main path: lu_factor(A, v=1536, precision='high') at N=32768
     f32 (one warm-up, then timed runs), K1's launches per factorization,
     peak device memory, and the blocked residual;
  7. flat path: the same with scheme='flat', K1's and K3's launches;
  8. Cholesky path: cholesky(A, v=1536, precision='high') at N=32768.

Each path's launch counts are set to 0 just before it and read just after.
The line before the last but one is a JSON object with each kernel's
numbers: its `launches` are summed over the three main paths (each one
warm-up and REPS timed factorizations), and `launches_by_path` gives each
path's count. The line before the last is the card's name and power
limit; the last line is {"ok": true, "device": {...}}.
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
K3_FLAT = -(-N // V) - 1
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


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


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


def phase_build():
    from conflux_tpu_torch.ops import _build, cuda_gemm, cuda_panel

    t0 = time.perf_counter()
    _build.build(["rank1_panel", "schur_update"])
    cuda_panel._load()
    cuda_gemm._load()
    print(f"build: rank1_panel and schur_update built and loaded in "
          f"{time.perf_counter() - t0:.2f} s")
    for name in ("rank1_panel", "schur_update"):
        for line in _build.build_log(name).splitlines():
            if ("registers" in line or "Compiling entry" in line
                    or "spill" in line):
                print(f"  {name}: " + line.strip())
    print(f"  schur_update: dynamic shared memory "
          f"{cuda_gemm._load().conflux_schur_update_smem_bytes()} bytes "
          f"per CTA (rank1_panel: up to 200 KB, sized per call)")


def phase_k1():
    import torch

    from conflux_tpu_torch.ops import cuda_panel
    from conflux_tpu_torch.ops.panel import _rank1_block_t
    from conflux_tpu_torch.timing import median_ms

    # (w, m, mode, j0, seed)
    cases = [(w, m, mode, 0, 1000 * si + len(mode))
             for si, (w, m) in enumerate(PANEL_SHAPES)
             for mode in ("unforced", "forced", "finish")]
    cases += [(w, m, "forced", j0, 7000 + ti)
              for ti, (w, m, j0) in enumerate(FORCED_TILES)]
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

        ref, got = plain(), kernel()
        torch.cuda.synchronize()
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
        t_k = median_ms(kernel)
        t_p = median_ms(plain)
        tag = f"K1 [{w}, {m}] {mode} j0={j0}"
        print(f"{tag}: pivots equal {piv_ok}, ok equal {ok_ok}, avail equal "
              f"{av_ok}, max|diff| {diff:.3e} (max|ref| {scale:.3e}, rel "
              f"{diff / scale:.3e}), kernel {t_k:.4f} ms, plain {t_p:.4f} ms")
        if not (piv_ok and ok_ok and av_ok):
            fail(f"{tag}: pivots/ok/avail disagree")
        if not diff <= KERNEL_TOL * scale:
            fail(f"{tag}: max|diff| {diff} > {KERNEL_TOL} * {scale}")
        rows.append({"shape": (w, m), "mode": mode, "j0": j0,
                     "max_abs_err": diff, "ms": t_k, "plain_ms": t_p})
    return rows


def _bf16_ulp(x):
    """Spacing of bfloat16 numbers at each element of x (8 significant
    bits; the smallest subnormal at 0)."""
    import torch

    _, e = torch.frexp(x.float())
    ulp = torch.ldexp(torch.ones_like(x, dtype=torch.float32), e - 8)
    return torch.where(x == 0, 2.0 ** -133, ulp)


def phase_k3():
    import torch

    from conflux_tpu_torch.ops import cuda_gemm
    from conflux_tpu_torch.ops.gemm import _schur_update_t
    from conflux_tpu_torch.timing import median_ms

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
            got = cuda_gemm.schur_update(R0.clone(), A, B, c0, mode, c1)
            torch.cuda.synchronize()
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
            t_k = median_ms(cuda_gemm.schur_update, got, A, B, c0, mode, c1)
            t_p = median_ms(_schur_update_t, ref, A, B, c0, mode, c1)
            tflops = 2.0 * m * (c1 - c0) * k / (t_k * 1e-3) / 1e12
            print(f"K3 {tag} R [{m}, {ncols}] k {k} span [{c0}, {c1}) "
                  f"{mode:7s}: max|diff| {diff:.3e}, {check}, outside span "
                  f"unchanged {outside}, kernel {t_k:.4f} ms "
                  f"({tflops:.1f} TFLOP/s of A@B), plain {t_p:.4f} ms")
            if not outside:
                fail(f"K3 {tag} {mode}: columns outside [{c0}, {c1}) changed")
            if not good:
                fail(f"K3 {tag} {mode}: kernel and plain disagree ({check})")
            rows.append({"shape": tag, "mode": mode, "max_abs_err": diff,
                         "ms": t_k, "plain_ms": t_p})
            del ref, got
        del A, B, R32
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
    for scheme in ("crout", "flat", "recursive"):
        for prec in ("high", "highest"):
            F, perm = lu_factor(A, v=256, precision=prec, scheme=scheme)
            torch.cuda.synchronize()
            tag = f"LU {scheme} N={n} {prec}"
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


def _reset_counts():
    from conflux_tpu_torch.ops import cuda_gemm, cuda_panel

    cuda_panel.LAUNCHES = 0
    cuda_gemm.LAUNCHES = 0


def _counts():
    from conflux_tpu_torch.ops import cuda_gemm, cuda_panel

    return {"rank1_panel": cuda_panel.LAUNCHES,
            "schur_update": cuda_gemm.LAUNCHES}


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


def _expect(per_run, want: dict, tag: str):
    for name, n in want.items():
        got = [c[name] for c in per_run]
        if any(c != n for c in got):
            fail(f"{tag}: {name} launches per factorization {got}, "
                 f"expected {n}")


def phase_lu_path(smi: str, scheme: str):
    import torch

    from conflux_tpu_torch.lu.single import lu_factor

    g = torch.Generator(device="cuda").manual_seed(42)
    A = 5.0 + torch.rand(N, N, generator=g, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    times, per_run, (F, perm) = _timed_path(
        lambda a: lu_factor(a, V, "high", scheme=scheme), A)
    counts = _counts()
    peak = torch.cuda.max_memory_allocated()
    want = ({"rank1_panel": K1_CROUT, "schur_update": 0} if scheme == "crout"
            else {"rank1_panel": K1_FLAT, "schur_update": K3_FLAT})
    _expect(per_run, want, f"{scheme} N={N}")
    med = statistics.median(times)
    res = _check_factor(A, F, perm, f"{scheme} N={N} high")
    print(f"{scheme} path N={N} v={V} 'high' on {smi}: times ms "
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
    _expect(per_run, {"rank1_panel": K1_CHOLESKY, "schur_update": 0},
            f"Cholesky N={N}")
    med = statistics.median(times)
    res = _check_cholesky(A, L, f"Cholesky N={N} high")
    print(f"Cholesky path N={N} v={V} 'high' on {smi}: times ms "
          f"{[round(t, 3) for t in times]}, median {med:.3f} ms, "
          f"{N ** 3 / 3.0 / (med * 1e-3) / 1e9:.1f} GFLOP/s, "
          f"peak memory {peak / 2 ** 30:.3f} GiB, launches per "
          f"factorization {per_run[-1]}, cholesky_residual_blocked "
          f"{res:.3e}")
    return counts


def main() -> int:
    smi = phase_device()
    import torch

    phase_build()
    k1_rows = phase_k1()
    k3_rows = phase_k3()
    phase_small()
    by_path = {"crout": phase_lu_path(smi, "crout"),
               "flat": phase_lu_path(smi, "flat"),
               "cholesky": phase_cholesky_path(smi)}
    launches = {name: sum(c[name] for c in by_path.values())
                for name in ("rank1_panel", "schur_update")}
    for name, n in launches.items():
        if n == 0:
            fail(f"{name} was never launched on the main paths")
    if "jax" in sys.modules:
        fail("jax was imported")
    # each kernel's row at its main-path shape and mode
    k1 = next(r for r in k1_rows
              if r["shape"] == PANEL_SHAPES[0] and r["mode"] == "finish")
    k3 = next(r for r in k3_rows
              if r["shape"] == "first" and r["mode"] == "high")
    print(json.dumps({"kernels": [{
        "name": "rank1_panel",
        "route": "cuda",
        "source": "conflux_tpu_torch/csrc/rank1_panel.cu",
        "replaces": "conflux_tpu/ops/pallas_panel.py:83",
        "launches": launches["rank1_panel"],
        "launches_by_path": {p: c["rank1_panel"] for p, c in by_path.items()},
        "max_abs_err": k1["max_abs_err"],
        "ms": k1["ms"],
        "plain_ms": k1["plain_ms"],
    }, {
        "name": "schur_update",
        "route": "cuda",
        "source": "conflux_tpu_torch/csrc/schur_update.cu",
        "replaces": "conflux_tpu/ops/pallas_gemm.py:95",
        "launches": launches["schur_update"],
        "launches_by_path": {p: c["schur_update"]
                             for p, c in by_path.items()},
        "max_abs_err": k3["max_abs_err"],
        "ms": k3["ms"],
        "plain_ms": k3["plain_ms"],
    }]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
