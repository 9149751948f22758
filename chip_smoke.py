#!/usr/bin/env python3
"""Run the PyTorch port's main path once on one CUDA card, and check it.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

  1. device: a CUDA card is required; print its name and power limit, the
     torch version, and assert that fp32 matrix products stay IEEE fp32;
  2. build: build (or load) K1, the rank-1 panel kernel, from csrc/;
  3. kernel vs plain: K1 against its plain PyTorch version on the same
     CUDA inputs, in unforced, forced and finish modes, at the main path's
     block shapes plus a ragged one with a masked lane;
  4. small end to end: lu_factor at N=2048 in 'high' and 'highest';
  5. main path: lu_factor(A, v=1536, precision='high') at N=32768 f32
     (one warm-up, then timed runs), K1's launches per factorization,
     peak device memory, and the blocked residual.

The line before the last is one JSON object with each kernel's numbers;
the last line is {"ok": true, "device": {...}}.
"""

import json
import statistics
import subprocess
import sys
import time

import numpy as np

N, V = 32768, 1536
REPS = 3
# K1 launches per N=32768 v=1536 factorization: 21 panels of 1536 columns
# at 12 blocks of 128, then one panel of 512 columns at 4
LAUNCHES_PER_FACTORIZATION = (N // V) * (V // 128) + (N % V) // 128
RESIDUAL_GATE = 1e-6
# K1 applies the rank-1 updates in another order than its two-level plain
# version, so the two agree to a few fp32 roundings, not bit for bit
KERNEL_TOL = 1e-4          # of max|ref|
RAGGED = (128, 1000)
PANEL_SHAPES = ((128, 32768), (128, 17408), RAGGED)
MASKED_LANE = 500          # masked in the ragged shape


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
    from conflux_tpu_torch.ops import _build, cuda_panel

    t0 = time.perf_counter()
    cuda_panel._load()
    print(f"build: rank1_panel built and loaded in "
          f"{time.perf_counter() - t0:.2f} s")
    for line in _build.build_log("rank1_panel").splitlines():
        if "registers" in line or "Compiling entry" in line:
            print("  " + line.strip())


def phase_kernel_vs_plain():
    import torch

    from conflux_tpu_torch.ops import cuda_panel
    from conflux_tpu_torch.ops.panel import _rank1_block_t
    from conflux_tpu_torch.timing import median_ms

    rows = []
    for si, (w, m) in enumerate(PANEL_SHAPES):
        for mode in ("unforced", "forced", "finish"):
            rng = np.random.default_rng(1000 * si + len(mode))
            A = rng.standard_normal((w, m)).astype(np.float32)
            forced, finish = mode == "forced", mode == "finish"
            if forced:
                # forced mode serves diagonally dominant tiles (no pivot
                # search): make the leading w lanes so
                A[np.arange(w), np.arange(w)] += w
            avail = np.ones((1, m), np.float32)
            if (w, m) == RAGGED:
                avail[0, MASKED_LANE] = 0.0
            Mt = torch.from_numpy(A).cuda()
            av = torch.from_numpy(avail).cuda()

            def plain():
                return _rank1_block_t(Mt, av, 0, forced, finish)

            def kernel():
                return cuda_panel.rank1_block_t(Mt, av, forced, 0, finish)

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
            print(f"K1 [{w}, {m}] {mode:8s}: pivots equal {piv_ok}, ok equal "
                  f"{ok_ok}, avail equal {av_ok}, max|diff| {diff:.3e} "
                  f"(max|ref| {scale:.3e}, rel {diff / scale:.3e}), "
                  f"kernel {t_k:.4f} ms, plain {t_p:.4f} ms")
            if not (piv_ok and ok_ok and av_ok):
                fail(f"K1 [{w}, {m}] {mode}: pivots/ok/avail disagree")
            if not diff <= KERNEL_TOL * scale:
                fail(f"K1 [{w}, {m}] {mode}: max|diff| {diff} > "
                     f"{KERNEL_TOL} * {scale}")
            rows.append({"shape": (w, m), "mode": mode, "max_abs_err": diff,
                         "ms": t_k, "plain_ms": t_p})
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


def phase_small():
    import torch

    from conflux_tpu_torch.lu.single import lu_factor
    from conflux_tpu_torch.validation import lu_residual_dense

    n = 2048
    g = torch.Generator(device="cuda").manual_seed(7)
    A = torch.randn(n, n, generator=g, device="cuda")
    for prec in ("high", "highest"):
        F, perm = lu_factor(A, v=256, precision=prec)
        torch.cuda.synchronize()
        res = _check_factor(A, F, perm, f"N={n} {prec}")
        # an independent float64 host reconstruction as the reference
        dense = lu_residual_dense(A.cpu().numpy(), F.cpu().numpy(),
                                  perm.cpu().numpy())
        print(f"N={n} v=256 {prec}: lu_residual_blocked {res:.3e}, "
              f"float64 host residual {dense:.3e}")
        if not dense <= RESIDUAL_GATE:
            fail(f"N={n} {prec}: float64 residual {dense}")


def phase_main(smi: str):
    import torch

    from conflux_tpu_torch.lu.single import lu_factor
    from conflux_tpu_torch.ops import cuda_panel
    from conflux_tpu_torch.timing import timed_run

    g = torch.Generator(device="cuda").manual_seed(42)
    A = 5.0 + torch.rand(N, N, generator=g, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_panel.LAUNCHES = 0
    times, per_run = [], []
    for rep in range(REPS + 1):
        before = cuda_panel.LAUNCHES
        ms, (F, perm) = timed_run(lu_factor, A, V, "high")
        per_run.append(cuda_panel.LAUNCHES - before)
        if rep:                                   # rep 0 is the warm-up
            times.append(ms)
        if rep < REPS:
            del F, perm
    launches = cuda_panel.LAUNCHES
    peak = torch.cuda.max_memory_allocated()
    if any(c != LAUNCHES_PER_FACTORIZATION for c in per_run):
        fail(f"K1 launches per factorization {per_run}, expected "
             f"{LAUNCHES_PER_FACTORIZATION}")
    med = statistics.median(times)
    res = _check_factor(A, F, perm, f"N={N} high")
    print(f"main path N={N} v={V} 'high' on {smi}: times ms "
          f"{[round(t, 3) for t in times]}, median {med:.3f} ms, "
          f"{2.0 / 3.0 * N ** 3 / (med * 1e-3) / 1e9:.1f} GFLOP/s, "
          f"peak memory {peak / 2 ** 30:.3f} GiB, K1 launches per "
          f"factorization {per_run}, lu_residual_blocked {res:.3e}")
    return launches


def main() -> int:
    smi = phase_device()
    import torch

    phase_build()
    rows = phase_kernel_vs_plain()
    phase_small()
    launches = phase_main(smi)
    if "jax" in sys.modules:
        fail("jax was imported")
    # the main path's shape and mode (unforced with finished pivot lanes)
    head = next(r for r in rows
                if r["shape"] == PANEL_SHAPES[0] and r["mode"] == "finish")
    print(json.dumps({"kernels": [{
        "name": "rank1_panel",
        "route": "cuda",
        "source": "conflux_tpu_torch/csrc/rank1_panel.cu",
        "replaces": "conflux_tpu/ops/pallas_panel.py:83",
        "launches": launches,
        "max_abs_err": head["max_abs_err"],
        "ms": head["ms"],
        "plain_ms": head["plain_ms"],
    }]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
