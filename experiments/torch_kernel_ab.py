"""A/B of kernel builds in one call: K1 (rank1_panel.cu), K1 in double
(rank1_panel_f64.cu), K3 (schur_update.cu), K2 and K4 (bigk_gemm.cu),
K5/K6 (row_move.cu) and the panel's pivot-triangle solve (panel_trsm.cu);
and K2 against its plain version at the step shapes of a crout and a
Cholesky factorization.

    python3 -m experiments.torch_kernel_ab --lib old=_ab/old \
        --lib new=conflux_tpu_torch/csrc [--lib name=dir ...] [--quick] \
        [--only k1|k1f64|k2|k2bf16|k3|k4|rows|trsm] [--steps]

Each --lib names a directory holding some of those sources (with the
csrc/ headers they include, or beside csrc/, whose headers are on the
include path too). Every source is built by its own nvcc with the port's
flags (ops/_build._FLAGS), all at once, into the gitignored _ab/build/,
and loaded with ctypes. An earlier commit's sources go into a gitignored
directory with `git show <commit>:conflux_tpu_torch/csrc/...`. Each
entry point's present C interface is taken and, where it changed, the
earlier one too (K1 and K4 report their route through a last int*
argument that the earlier builds lack; the present K3 and K2 take a
workspace in bytes for their split operands and report their route, the
earlier K3 takes none and the earlier K2 a float count for split-K alone).

Then, on the card, each build's kernels run at chip_smoke.py's shapes: K1
at the main paths' blocks and the cluster/grid boundary, K1 in double at
the f64 paths' blocks (chip_smoke.K1_F64_SHAPES) beside cuSOLVER's f64 LU
of the block and the package's float32 K1 at the same shape, K3 at the flat
LU's first and mid-run trailing updates in its three modes, K2 at
chip_smoke.K2_SHAPES in its three modes, K4 at the three prof_pallas_gemm
shapes for f32 and bf16, K5/K6 at the [32768, 32768] row moves and the
split path's panel gather. Builds take turns per shape (a, b, ..., b, a),
each timed as timing.per_call_ms (back-to-back calls between two events),
and every result is compared with the plain version (K1: pivots equal and
within 1e-4 of max|ref|; K2, K3 and K4 within 1e-5 of max(|A|@|B|), plus
one bf16 ulp for 'bf16out'; K5/K6 bit for bit). Prints one line per shape
and build, and the card's name and power limit.

--only k2bf16 holds K2's bf16-operand entry (conflux_sub_matmul_bigk_bf16)
of each build at chip_smoke.K2_BF16_SHAPES, in 'bf16' and 'bf16out', in
turns with the one library call that computes R - A @ B
(`torch.addmm(R, A, B, out_dtype=float32, alpha=-1)` in 'bf16',
`torch.addmm(R_bf16, A, B, alpha=-1)` with bf16 reduced-precision
reduction off in 'bf16out') and the plain version: each build, addmm,
plain, plain, addmm, each build in reverse, the lesser of each one's two
times. An earlier build whose entry takes no transposed B gets B^T copied
first, as its wrapper did, and that copy is timed with it. With --steps
the same turns run at the 41 big-K products of one N=32768, v=1536 bf16
crout and the 21 of one bf16 Cholesky (B the view G[k:k+w, :k].T), in
'bf16', with the sums over each factorization.

--only trsm holds each build's pivot-triangle solve at the panel's
shapes (TRSM_SHAPES: crout's block and group updates, Cholesky's block
update), in f32 and f64, to the plain version (the chain of 32-wide
inverses and products it replaces, `ops/panel._pivot_solve_plain`) within
2 eps kappa(L) max|B|, and times it in turns beside that chain and
torch.linalg.solve_triangular (cuBLAS's trsm): per call as
timing.per_call_ms (host launch work included where it is the longer)
and on the device alone (`graph_ms`: calls captured in a CUDA graph).

--steps times the package's K2 (ops/cuda_gemm.sub_matmul_bigk) against
its plain version (`R - schur_dot(A, B, mode)`, what the drivers ran
before they routed these products through K2) in turns, in 'high' and
'bf16', at every big-K product of one N=32768, v=1536 factorization: crout
'gather' at partition 1 (the panel update [N - k, k] x [k, 1536] and the
pivot-row refresh [1536, k] x [k, N - k - 1536]) and flat Cholesky (the
panel update [N - k, k] x [k, 1536], its B the view F[k:k+w, :k].T), as
strided slices of [N, N] buffers the way the paths take them; prints each
step and the sums over each factorization.
"""

import argparse
import ctypes
import subprocess
from pathlib import Path

import numpy as np
import torch

from conflux_tpu_torch.ops import _build, cuda_gemm, cuda_panel, \
    cuda_scatter, cuda_trsm
from conflux_tpu_torch.timing import per_call_ms

ROOT = Path(__file__).resolve().parent.parent
OUT = ROOT / "_ab" / "build"
K4_SHAPES = ((16384, 512, 16384), (8192, 1024, 8192), (8192, 8192, 8192))
N, V = 32768, 1536
STEMS = ("rank1_panel", "rank1_panel_f64", "schur_update", "bigk_gemm",
         "row_move", "panel_trsm")
# the pivot-triangle solve (r, n, group): crout's block update at its
# widest and its group update, Cholesky's 64-wide block update at its
# widest
TRSM_SHAPES = ((384, 128, False), (1024, 512, True), (448, 64, False))
# K1 (w, m, mode, j0): the main paths' blocks (crout's first and a late
# panel, a mid flat/swap/split panel, the forced tiles of flat's pivot
# rows and Cholesky's potrf, with their last and their second first
# pivots), a ragged block
K1_CASES = ((128, 32768, "finish", 0), (128, 17408, "unforced", 0),
            (128, 6656, "finish", 0), (128, 1536, "forced", 1408),
            (64, 1536, "forced", 1472), (128, 1000, "unforced", 0),
            (128, 1536, "forced", 128), (64, 1536, "forced", 64))
# K1's grid-route blocks of the benchmark's cells and of the other paths
# (w, m, mode, j0): crout's first block at N = 32768 and 16384, its
# narrowest grid block (128 lanes past the cluster route's widest), the
# distributed panels' per rank and the recursive scheme's widest pivot
# search. Every build's four outputs must be bit-identical to the first
# build's here.
K1_GRID_CASES = ((128, 32768, "finish", 0), (128, 16384, "finish", 0),
                 (128, 2176, "finish", 0), (64, 8192, "unforced", 0),
                 (64, 32768, "unforced", 0))
# K1 in double (w, m, mode, j0): chip_smoke.K1_F64_SHAPES, the f64 crout's
# first block, a mid panel, a last-panels block and the forced pivot-row
# and Cholesky tiles
K1_F64_CASES = ((128, 32768, "finish", 0), (128, 17408, "unforced", 0),
                (128, 2048, "unforced", 0), (128, 1536, "forced", 128),
                (64, 1536, "forced", 64))
# K3 (tag, m, ncols, k, c0, c1): chip_smoke's flat updates
K3_SHAPES = (("first", 32768, 32768, 1536, 1536, 32768),
             ("mid", 17408, 32768, 1536, 16896, 32768))
# K2 (tag, m, k, n): chip_smoke.K2_SHAPES (chip_smoke.py is not imported:
# it is a script)
# (without the Cholesky shape: PR 5's K2 takes no transposed B)
K2_SHAPES = (("panel k=1536", 31232, 1536, 1536),
             ("panel k=15360", 17408, 15360, 1536),
             ("panel k=30720", 2048, 30720, 1536),
             ("refresh k=15360", 1536, 15360, 15872),
             ("refresh k=30720", 1536, 30720, 512),
             ("ragged", 1000, 3001, 300))


def build(libs):
    """{name: {source stem: CDLL}} for each --lib directory."""
    OUT.mkdir(parents=True, exist_ok=True)
    jobs = []
    for name, d in libs.items():
        for stem in STEMS:
            cu = Path(d) / f"{stem}.cu"
            if not cu.exists():
                continue
            so = OUT / f"lib{stem}-{name}.so"
            cmd = [_build._nvcc(), *_build._FLAGS, f"-I{d}",
                   f"-I{_build._CSRC}", "-o", str(so), str(cu)]
            jobs.append((name, stem, so, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
    loaded = {name: {} for name in libs}
    for name, stem, so, proc in jobs:
        out, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name} {stem}:\n{err}")
        for line in (out + err).splitlines():
            if "registers" in line or "spill" in line or "arning" in line:
                print(f"  {name} {stem}: {line.strip()}")
        loaded[name][stem] = ctypes.CDLL(str(so))
    return loaded


def matmul_fn(lib):
    p, i = ctypes.c_void_p, ctypes.c_int
    f = lib.conflux_matmul
    # the present interface; the earlier entry point, with one argument
    # fewer, ignores the trailing pointer under the C calling convention
    f.argtypes = [p, i, p, i, p, i, i, i, i, i, p, ctypes.POINTER(i)]
    f.restype = i

    def run(a, b):
        m, k = a.shape
        n = b.shape[1]
        c = torch.empty((m, n), dtype=torch.float32, device="cuda")
        route = ctypes.c_int(-1)
        err = f(a.data_ptr(), a.stride(0), b.data_ptr(), b.stride(0),
                c.data_ptr(), c.stride(0), m, n, k,
                int(a.dtype == torch.bfloat16),
                torch.cuda.current_stream().cuda_stream, ctypes.byref(route))
        if err:
            raise RuntimeError(f"conflux_matmul error {err}")
        return c
    return run


def row_move_fn(lib, scatter: bool):
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    f = lib.conflux_row_move
    f.argtypes = [i, p, ll, p, ll, p, i, ll, ll, p, ctypes.POINTER(i)]
    f.restype = i

    def call(src, dst, idx, m):
        es = src.element_size()
        route = ctypes.c_int(-1)
        err = f(int(scatter), src.data_ptr(), src.stride(0) * es,
                dst.data_ptr(), dst.stride(0) * es, idx.data_ptr(),
                idx.shape[0], m, src.shape[1] * es,
                torch.cuda.current_stream().cuda_stream, ctypes.byref(route))
        if err:
            raise RuntimeError(f"conflux_row_move error {err}")

    if scatter:
        def run(R, src, idx):
            call(src, R, idx, R.shape[0])
            return R
    else:
        def run(R, idx):
            out = torch.empty((idx.shape[0], R.shape[1]), dtype=R.dtype,
                              device="cuda")
            call(R, out, idx, R.shape[0])
            return out
    return run


def rank1_fn(lib):
    p, i = ctypes.c_void_p, ctypes.c_int
    f = lib.conflux_rank1_panel
    # the present interface; an earlier one, without the route pointer or
    # the cluster size's, ignores them under the C calling convention (and
    # leaves the cluster size 0)
    f.argtypes = [p, p, p, p, p, p, p, i, i, i, i, p, ctypes.POINTER(i),
                  ctypes.POINTER(i)]
    f.restype = i
    lib.conflux_rank1_panel_scratch_floats.argtypes = [i]
    lib.conflux_rank1_panel_scratch_floats.restype = i
    routes, clusters = {}, {}
    # one zeroed scratch per width, kept across calls as the package's
    # wrapper keeps its own (the grid route's tagged slots need it)
    scratches = {}

    def run(Mt, av, forced, j0):
        w, m = Mt.shape
        out, avo = torch.empty_like(Mt), torch.empty_like(av)
        piv = torch.empty(w, dtype=torch.int32, device="cuda")
        ok = torch.empty(w, dtype=torch.int32, device="cuda")
        if w not in scratches:
            scratches[w] = torch.zeros(
                lib.conflux_rank1_panel_scratch_floats(w), device="cuda")
        route, cluster = ctypes.c_int(-1), ctypes.c_int(0)
        err = f(Mt.data_ptr(), av.data_ptr(), out.data_ptr(), avo.data_ptr(),
                piv.data_ptr(), ok.data_ptr(), scratches[w].data_ptr(), w, m,
                int(forced), j0, torch.cuda.current_stream().cuda_stream,
                ctypes.byref(route), ctypes.byref(cluster))
        if err:
            raise RuntimeError(f"conflux_rank1_panel error {err}")
        routes[(w, m)] = route.value
        clusters[(w, m)] = cluster.value
        return out, avo, piv, ok
    run.routes = routes
    run.clusters = clusters
    return run


def rank1_f64_fn(lib):
    p, i = ctypes.c_void_p, ctypes.c_int
    f = lib.conflux_rank1_panel_f64
    f.argtypes = [p, p, p, p, p, p, p, i, i, i, i, p, ctypes.POINTER(i)]
    f.restype = i
    lib.conflux_rank1_panel_f64_scratch_doubles.argtypes = [i]
    lib.conflux_rank1_panel_f64_scratch_doubles.restype = i
    routes = {}

    def run(Mt, av, forced, j0):
        w, m = Mt.shape
        out, avo = torch.empty_like(Mt), torch.empty_like(av)
        piv = torch.empty(w, dtype=torch.int32, device="cuda")
        ok = torch.empty(w, dtype=torch.int32, device="cuda")
        scratch = torch.empty(
            lib.conflux_rank1_panel_f64_scratch_doubles(w),
            dtype=torch.float64, device="cuda")
        route = ctypes.c_int(-1)
        err = f(Mt.data_ptr(), av.data_ptr(), out.data_ptr(), avo.data_ptr(),
                piv.data_ptr(), ok.data_ptr(), scratch.data_ptr(), w, m,
                int(forced), j0, torch.cuda.current_stream().cuda_stream,
                ctypes.byref(route))
        if err:
            raise RuntimeError(f"conflux_rank1_panel_f64 error {err}")
        routes[(w, m)] = route.value
        return out, avo, piv, ok
    run.routes = routes
    return run


def schur_fn(lib):
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    f = lib.conflux_schur_update
    split = hasattr(lib, "conflux_schur_update_workspace_bytes")
    if split:
        f.argtypes = [p, i, i, p, i, p, i, i, i, i, i, p, ll, p,
                      ctypes.POINTER(i)]
        lib.conflux_schur_update_workspace_bytes.argtypes = [i, i, i, i]
        lib.conflux_schur_update_workspace_bytes.restype = ll
    else:
        f.argtypes = [p, i, i, p, i, p, i, i, i, i, i, p]
    f.restype = i

    def run(R, A, B, c0, mode, c1):
        from conflux_tpu_torch.ops.gemm import MODES

        passes = MODES[mode][1]
        m, k, nt = R.shape[0], A.shape[1], c1 - c0
        span = R[:, c0:c1]
        args = [span.data_ptr(), int(mode == "bf16out"), R.stride(0),
                A.data_ptr(), A.stride(0), B.data_ptr(), B.stride(0), m, nt,
                k, passes]
        stream = torch.cuda.current_stream().cuda_stream
        if split:
            nb = lib.conflux_schur_update_workspace_bytes(m, nt, k, passes)
            ws = torch.empty(nb, dtype=torch.uint8, device="cuda")
            route = ctypes.c_int(-1)
            err = f(*args, ws.data_ptr(), nb, stream, ctypes.byref(route))
        else:
            err = f(*args, stream)
        if err:
            raise RuntimeError(f"conflux_schur_update error {err}")
        return R
    return run


def bigk_fn(lib):
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    f = lib.conflux_sub_matmul_bigk
    split = hasattr(lib, "conflux_sub_matmul_bigk_workspace_bytes")
    if split:
        f.argtypes = [p, i, p, i, i, p, i, p, i, i, i, i, i, i, p, ll, p,
                      ctypes.POINTER(i)]
        size = lib.conflux_sub_matmul_bigk_workspace_bytes
        size.argtypes = [i, i, i, i]
    else:
        f.argtypes = [p, i, p, i, i, p, i, p, i, i, i, i, i, p, ll, p]
        size = lib.conflux_sub_matmul_bigk_workspace_floats
        size.argtypes = [i, i, i]
    size.restype = ll
    f.restype = i

    def run(R, A, B, mode):
        from conflux_tpu_torch.ops.gemm import MODES

        passes = MODES[mode][1]
        m, k = A.shape
        n = B.shape[1]
        out = torch.empty((m, n), dtype=R.dtype, device="cuda")
        args = [R.data_ptr(), R.stride(0), out.data_ptr(), out.stride(0),
                int(mode == "bf16out"), A.data_ptr(), A.stride(0),
                B.data_ptr(), B.stride(0)]
        stream = torch.cuda.current_stream().cuda_stream
        if split:
            nb = size(m, n, k, passes)
            ws = torch.empty(nb, dtype=torch.uint8, device="cuda")
            route = ctypes.c_int(-1)
            err = f(*args, 0, m, n, k, passes, ws.data_ptr(), nb, stream,
                    ctypes.byref(route))
        else:
            nf = size(m, n, k)
            ws = torch.empty(max(nf, 1), dtype=torch.float32, device="cuda")
            err = f(*args, m, n, k, passes, ws.data_ptr(), nf, stream)
        if err:
            raise RuntimeError(f"conflux_sub_matmul_bigk error {err}")
        return out
    return run


def bigk_bf16_fn(lib):
    """K2's bf16-operand entry of a build: run(R, A, B, mode). The present
    entry reads a transposed B (unit row stride) in place and takes
    split-K counters; an earlier one (no conflux_sub_matmul_bigk_bf16_
    counters) reads row-major operands only, so B^T is copied first."""
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    f = lib.conflux_sub_matmul_bigk_bf16
    size = lib.conflux_sub_matmul_bigk_bf16_workspace_bytes
    size.argtypes = [i, i, i]
    size.restype = ll
    present = hasattr(lib, "conflux_sub_matmul_bigk_bf16_counters")
    if present:
        f.argtypes = [p, i, p, i, i, p, i, p, i, i, i, i, i, p, ll, p, i, p,
                      ctypes.POINTER(i)]
        slots = lib.conflux_sub_matmul_bigk_bf16_counters
        slots.argtypes = [i, i, i]
        slots.restype = i
        counters = torch.zeros(1 << 16, dtype=torch.int32, device="cuda")
    else:
        f.argtypes = [p, i, p, i, i, p, i, p, i, i, i, i, p, ll, p,
                      ctypes.POINTER(i)]
    f.restype = i

    def run(R, A, B, mode):
        m, k = A.shape
        n = B.shape[1]
        kmajor = present and B.stride(0) == 1 and n > 1
        if not kmajor and B.stride(1) != 1:
            B = B.contiguous()
        Bs = B.T if kmajor else B
        out = torch.empty((m, n), dtype=R.dtype, device="cuda")
        nb = size(m, n, k)
        ws = torch.empty(max(nb, 1), dtype=torch.uint8, device="cuda")
        route = ctypes.c_int(-1)
        args = [R.data_ptr(), R.stride(0), out.data_ptr(), out.stride(0),
                int(mode == "bf16out"), A.data_ptr(), A.stride(0),
                Bs.data_ptr(), Bs.stride(0)]
        stream = torch.cuda.current_stream().cuda_stream
        if present:
            assert slots(m, n, k) <= counters.numel()
            err = f(*args, int(kmajor), m, n, k, ws.data_ptr(), nb,
                    counters.data_ptr(), counters.numel(), stream,
                    ctypes.byref(route))
        else:
            err = f(*args, m, n, k, ws.data_ptr(), nb, stream,
                    ctypes.byref(route))
        if err:
            raise RuntimeError(f"conflux_sub_matmul_bigk_bf16 error {err}")
        run.route = route.value
        return out
    return run


def trsm_fn(lib):
    p, i = ctypes.c_void_p, ctypes.c_int
    f = lib.conflux_panel_trsm
    f.argtypes = [p, p, p, i, i, i, p]
    f.restype = i

    def run(B, lu):
        r, n = B.shape
        X = torch.empty_like(B)
        err = f(B.data_ptr(), lu.data_ptr(), X.data_ptr(), r, n,
                int(B.dtype == torch.float64),
                torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"conflux_panel_trsm error {err}")
        return X
    return run


def library_sub_bf16(mode):
    """(fn(R, A, B), label): the one PyTorch call that computes R - A @ B
    on bf16 operands in `mode`, or, where this torch refuses the out_dtype
    overload, R - torch.mm(A, B, out_dtype=float32) labelled as two
    calls."""
    if mode == "bf16out":
        def one(R, A, B):
            knob = torch.backends.cuda.matmul
            before = knob.allow_bf16_reduced_precision_reduction
            knob.allow_bf16_reduced_precision_reduction = False
            try:
                return torch.addmm(R, A, B, alpha=-1)
            finally:
                knob.allow_bf16_reduced_precision_reduction = before
        return one, "addmm"
    try:
        a = torch.ones(8, 8, dtype=torch.bfloat16, device="cuda")
        torch.addmm(torch.zeros(8, 8, device="cuda"), a, a,
                    out_dtype=torch.float32, alpha=-1)
    except (TypeError, RuntimeError, NotImplementedError):
        return (lambda R, A, B: R - torch.mm(A, B, out_dtype=torch.float32),
                "R - torch.mm(out_dtype=float32), two calls")
    return (lambda R, A, B: torch.addmm(R, A, B, out_dtype=torch.float32,
                                        alpha=-1),
            "addmm(out_dtype=float32)")


def _k2_bad(got, ref, tol, mode):
    """Elements of a K2 result off its plain version: the fp32 summation
    tolerance, plus one bf16 ulp where the result is bf16."""
    d = (got.float() - ref.float()).abs()
    if mode == "bf16out":
        _, e = torch.frexp(ref.float())
        return int((d > torch.ldexp(torch.ones_like(d), e - 8) + tol).sum())
    return int((d > tol).sum())


def ab_k2(libs, quick):
    from conflux_tpu_torch.ops.gemm import _sub_matmul_bigk_t

    names = [n for n in libs if "bigk_gemm" in libs[n]]
    fns = {n: bigk_fn(libs[n]["bigk_gemm"]) for n in names}
    shapes = K2_SHAPES[:2] if quick else K2_SHAPES
    for si, (tag, m, k, n) in enumerate(shapes):
        g = torch.Generator(device="cuda").manual_seed(900 + si)
        A = torch.randn(m, k, generator=g, device="cuda")
        B = torch.randn(k, n, generator=g, device="cuda")
        R32 = torch.randn(m, n, generator=g, device="cuda")
        tol = 1e-5 * float(torch.mm(A.abs(), B.abs()).max())
        splits = cuda_gemm.sub_matmul_bigk_splits(m, n, k)
        for mode in ("high", "bf16", "bf16out"):
            R = R32.to(torch.bfloat16) if mode == "bf16out" else R32
            ref = _sub_matmul_bigk_t(R, A, B, mode)
            times = {nm: [] for nm in names}
            for nm in turns(names):
                got = fns[nm](R, A, B, mode)
                torch.cuda.synchronize()
                bad = _k2_bad(got, ref, tol, mode)
                if bad:
                    raise SystemExit(f"K2 {nm} {tag} {mode}: {bad} elements "
                                     "off the plain version")
                del got
                times[nm].append(per_call_ms(fns[nm], R, A, B, mode))
            t_p = per_call_ms(_sub_matmul_bigk_t, R, A, B, mode)
            flop = 2.0 * m * n * k
            for nm in names:
                best = min(times[nm])
                print(f"K2 {tag} [{m} x {n}, k {k}] {mode:7s} {nm:8s}: "
                      f"{[round(t, 3) for t in times[nm]]} ms, best "
                      f"{best:.3f} ms ({flop / best / 1e9:.1f} TFLOP/s of "
                      f"A@B; package splits {splits}), plain {t_p:.3f} ms")
            del ref
        del A, B, R32
        torch.cuda.empty_cache()


# chip_smoke.K2_BF16_SHAPES (tag, m, k, n, B transposed)
K2_BF16_SHAPES = (("crout panel k=1536", N - V, V, V, False),
                  ("crout panel k=32256", N % V, N - N % V, N % V, False),
                  ("Cholesky k=1536", N - V, V, V, True),
                  ("Cholesky k=32256", N % V, N - N % V, N % V, True))


def _bf16_turns(fns, R, A, B, mode, tag, library):
    """Each build's entry, the library call and the plain version in turns
    (builds, library, plain, plain, library, builds reversed): every
    result checked against the plain version, each build's repeated call
    bit for bit; returns {name: lesser of its two ms}."""
    from conflux_tpu_torch.ops.gemm import _sub_matmul_bigk_t

    ref = _sub_matmul_bigk_t(R, A, B, mode)
    tol = 1e-5 * float(torch.mm(A.float().abs(), B.float().abs()).max())
    for nm, fn in fns.items():
        got = fn(R, A, B, mode)
        bad = _k2_bad(got, ref, tol, mode)
        if bad or not torch.equal(got, fn(R, A, B, mode)):
            raise SystemExit(f"K2 bf16 {nm} {tag} {mode}: {bad} elements off "
                             "the plain version, or a repeat differs")
        del got
    lib_fn = lambda R, A, B, mode: library(R, A, B)   # noqa: E731
    bad = _k2_bad(lib_fn(R, A, B, mode), ref, tol, mode)
    if bad:
        print(f"  (library call off the plain version at {bad} elements)")
    del ref
    order = [*fns, "library", "plain"]
    calls = {**fns, "library": lib_fn, "plain": _sub_matmul_bigk_t}
    times = {nm: [] for nm in order}
    for nm in order + order[::-1]:
        times[nm].append(per_call_ms(calls[nm], R, A, B, mode))
    return {nm: min(t) for nm, t in times.items()}


def ab_k2bf16(libs, quick, steps=False):
    names = [n for n in libs if "bigk_gemm" in libs[n]]
    fns = {n: bigk_bf16_fn(libs[n]["bigk_gemm"]) for n in names}
    for nm in names:
        lib = libs[nm]["bigk_gemm"]
        if hasattr(lib, "conflux_sub_matmul_bigk_bf16_clusters"):
            print(f"K2 bf16 {nm}: "
                  f"{lib.conflux_sub_matmul_bigk_bf16_clusters()} ping-pong "
                  "clusters at once")
    shapes = K2_BF16_SHAPES[:1] if quick else K2_BF16_SHAPES
    for si, (tag, m, k, n, bt) in enumerate(shapes):
        g = torch.Generator(device="cuda").manual_seed(950 + si)
        A = torch.randn(m, k, generator=g, device="cuda").to(torch.bfloat16)
        B = (torch.randn(n, k, generator=g, device="cuda")
             .to(torch.bfloat16).T if bt else
             torch.randn(k, n, generator=g, device="cuda")
             .to(torch.bfloat16))
        R32 = torch.randn(m, n, generator=g, device="cuda")
        for mode in ("bf16", "bf16out"):
            R = R32.to(torch.bfloat16) if mode == "bf16out" else R32
            library, label = library_sub_bf16(mode)
            t = _bf16_turns(fns, R, A, B, mode, tag, library)
            bytes_ = (2.0 * R.element_size() * m * n + 2.0 * (m * k + k * n))
            bound = max(2.0 * m * n * k / 989e12, bytes_ / 3.35e12) * 1e3
            routes = {nm: fns[nm].route for nm in names}
            print(f"K2 bf16 {tag} R [{m}, {n}] k {k} {mode:7s}: " + ", ".join(
                f"{nm} {t[nm]:.4f} ms (route {routes[nm]})" for nm in names)
                + f", {label} {t['library']:.4f} ms, plain {t['plain']:.4f} "
                f"ms, bound {bound:.4f} ms")
        del A, B, R32, R
        torch.cuda.empty_cache()
    if steps:
        bf16_steps(fns)


def bf16_steps(fns):
    """The bf16 entry of each build against addmm and the plain version
    at each big-K product of one N, V bf16 crout and one bf16 Cholesky,
    in 'bf16' (f32 R, bf16 operands as views of [N, N] bf16 buffers)."""
    g = torch.Generator(device="cuda").manual_seed(42)
    Rb = torch.randn(N, N, generator=g, device="cuda").to(torch.bfloat16)
    Fb = torch.randn(N, N, generator=g, device="cuda").to(torch.bfloat16)
    Gb = torch.randn(N, N, generator=g, device="cuda").to(torch.bfloat16)
    buf = torch.randn(N * V, generator=g, device="cuda")
    library, label = library_sub_bf16("bf16")
    crout, chol = [], []
    for k in range(V, N, V):
        w = min(V, N - k)
        m_r = N - k
        crout.append((f"panel k={k}", buf[:m_r * w].view(m_r, w),
                      Rb[:m_r, :k], Fb[:k, k:k + w]))
        if k + w < N:
            crout.append((f"refresh k={k}", buf[:w * (N - k - w)]
                          .view(w, N - k - w), Rb[:w, :k], Fb[:k, k + w:]))
        chol.append((f"panel k={k}", buf[:m_r * w].view(m_r, w), Fb[k:, :k],
                     Gb[k:k + w, :k].T))
    for path, calls in (("crout", crout), ("Cholesky", chol)):
        sums = {}
        for tag, R, A, B in calls:
            t = _bf16_turns(fns, R, A, B, "bf16", tag, library)
            for nm, ms in t.items():
                sums[nm] = sums.get(nm, 0.0) + ms
            print(f"bf16 {path} {tag} [{A.shape[0]} x {B.shape[1]}, k "
                  f"{A.shape[1]}]: " + ", ".join(f"{nm} {ms:.4f}"
                                                 for nm, ms in t.items())
                  + " ms")
        print(f"bf16 {path} over the factorization's {len(calls)} big-K "
              f"products ({label} as library): " + ", ".join(
                  f"{nm} {ms:.3f}" for nm, ms in sums.items()) + " ms")
        torch.cuda.empty_cache()


def path_steps(modes=("high", "bf16")):
    """K2 against its plain version at each big-K product of one N, V crout
    'gather' and one flat Cholesky factorization, in turns (plain, K2, K2,
    plain)."""
    from conflux_tpu_torch.ops.gemm import _sub_matmul_bigk_t

    g = torch.Generator(device="cuda").manual_seed(42)
    R = torch.randn(N, N, generator=g, device="cuda")
    F = torch.randn(N, N, generator=g, device="cuda")
    # Cholesky's B takes F[k:k+w, :k].T's strides from a buffer of its own:
    # F's own rows times themselves sum k positive terms, whose rounding in
    # two summation orders drifts past the 1e-5 * max(|A|@|B|) check
    G = torch.randn(N, N, generator=g, device="cuda")
    crout, chol = [], []
    for k in range(V, N, V):
        w = min(V, N - k)
        m_r = N - k
        # the panel update, then (where columns remain) the refresh of the
        # w pivot rows Rpiv, a [w, N] gather
        crout.append((f"panel k={k}", R[:m_r, k:k + w], R[:m_r, :k],
                      F[:k, k:k + w]))
        if k + w < N:
            crout.append((f"refresh k={k}", R[:w, k + w:], R[:w, :k],
                          F[:k, k + w:]))
        chol.append((f"panel k={k}", F[k:, k:k + w], F[k:, :k],
                     G[k:k + w, :k].T))
    for path, calls in (("crout", crout), ("Cholesky", chol)):
        for mode in modes:
            sums = {"K2": 0.0, "plain": 0.0}
            for tag, Rs, A, B in calls:
                tol = 1e-5 * float(torch.mm(A.abs(), B.abs()).max())
                bad = _k2_bad(cuda_gemm.sub_matmul_bigk(Rs, A, B, mode),
                              _sub_matmul_bigk_t(Rs, A, B, mode), tol, mode)
                if bad:
                    raise SystemExit(f"K2 {path} {tag} {mode}: {bad} elements "
                                     "off")
                t_p = per_call_ms(_sub_matmul_bigk_t, Rs, A, B, mode)
                t_k = per_call_ms(cuda_gemm.sub_matmul_bigk, Rs, A, B, mode)
                t_k = min(t_k, per_call_ms(cuda_gemm.sub_matmul_bigk, Rs, A, B,
                                           mode))
                t_p = min(t_p, per_call_ms(_sub_matmul_bigk_t, Rs, A, B, mode))
                sums["K2"] += t_k
                sums["plain"] += t_p
                print(f"{path} {mode} {tag} [{A.shape[0]} x {B.shape[1]}, k "
                      f"{A.shape[1]}]: K2 {t_k:.3f} ms, plain (schur_dot + "
                      f"subtract) {t_p:.3f} ms, K2/plain {t_k / t_p:.3f}")
            print(f"{path} {mode} over the factorization's {len(calls)} "
                  f"big-K products: K2 {sums['K2']:.3f} ms, plain "
                  f"{sums['plain']:.3f} ms, K2/plain "
                  f"{sums['K2'] / sums['plain']:.3f}")
            torch.cuda.empty_cache()


def ab_k1(libs, quick, unchecked=False):
    from conflux_tpu_torch.ops.panel import _rank1_block_t

    names = [n for n in libs if "rank1_panel" in libs[n]]
    fns = {n: rank1_fn(libs[n]["rank1_panel"]) for n in names}
    cases = [K1_CASES[i] for i in (0, 3, 6)] if quick else list(K1_CASES)
    # the cluster route's widest block at w = 128 and 128 lanes more
    edge = cuda_panel.cluster_max_m(128)
    cases += [(128, edge, "finish", 0), (128, edge + 128, "finish", 0)]
    cases += [c for c in K1_GRID_CASES if c not in cases]
    for w, m, mode, j0 in cases:
        exact = (w, m, mode, j0) in K1_GRID_CASES
        rng = np.random.default_rng(w + m + j0)
        A = rng.standard_normal((w, m)).astype(np.float32)
        forced = mode == "forced"
        if forced:
            A[np.arange(w), j0 + np.arange(w)] += w
        avail = np.ones((1, m), np.float32)
        avail[0, :j0] = 0.0
        Mt, av = torch.from_numpy(A).cuda(), torch.from_numpy(avail).cuda()
        ref = _rank1_block_t(Mt, av, j0, forced, mode == "finish")
        keep = torch.ones(m, dtype=torch.bool, device="cuda")
        if mode == "unforced":
            keep[ref[2]] = False
        times = {nm: [] for nm in names}
        first = None
        for nm in turns(names):
            got = fns[nm](Mt, av, forced, j0)
            torch.cuda.synchronize()
            if exact and first is None:
                first = (nm, got)
            elif exact and not all(torch.equal(a, b)
                                   for a, b in zip(first[1], got)):
                msg = (f"K1 {nm} [{w}, {m}] {mode}: not bit-identical to "
                       f"{first[0]}'s outputs")
                if not unchecked:
                    raise SystemExit(msg)
                print(msg + ", timed all the same (--unchecked)")
            diff = float((ref[0] - got[0])[:, keep].abs().max())
            if not (torch.equal(ref[2], got[2].long())
                    and diff <= 1e-4 * float(ref[0][:, keep].abs().max())):
                msg = f"K1 {nm} [{w}, {m}] {mode}: disagrees ({diff})"
                if not unchecked:
                    raise SystemExit(msg)
                print(msg + ", timed all the same (--unchecked)")
            times[nm].append(per_call_ms(fns[nm], Mt, av, forced, j0))
        t_w = per_call_ms(cuda_panel.rank1_block_t, Mt, av, forced, j0)
        for nm in names:
            best = min(times[nm])
            route = cuda_panel.ROUTES.get(fns[nm].routes.get((w, m)),
                                          "one route")
            cluster = fns[nm].clusters.get((w, m), 0)
            if cluster > 1:
                route += f", clusters of {cluster}"
            same = ", bit-identical to the first build" if exact else ""
            print(f"K1 [{w}, {m}] {mode:8s} j0={j0:<5d} {nm:8s} ({route}): "
                  f"{[round(t, 4) for t in times[nm]]} ms, best {best:.4f} "
                  f"ms ({best / w * 1e3:.2f} us per column){same}; package "
                  f"wrapper {t_w:.4f} ms")
        del Mt, av, ref


def ab_k1f64(libs, quick, unchecked=False):
    """K1 in double: each build against the plain version in f64 (pivots
    equal, within chip_smoke's 1e-12 of max|ref|), in turns, beside
    cuSOLVER's f64 LU of the block and the package's float32 K1 on the
    same values rounded to f32."""
    from conflux_tpu_torch.ops.panel import _rank1_block_t

    names = [n for n in libs if "rank1_panel_f64" in libs[n]]
    fns = {n: rank1_f64_fn(libs[n]["rank1_panel_f64"]) for n in names}
    cases = K1_F64_CASES[::2] if quick else K1_F64_CASES
    for w, m, mode, j0 in cases:
        rng = np.random.default_rng(w + m + j0)
        A = rng.standard_normal((w, m))
        forced = mode == "forced"
        if forced:
            A[np.arange(w), j0 + np.arange(w)] += w
        avail = np.ones((1, m))
        avail[0, :j0] = 0.0
        Mt, av = torch.from_numpy(A).cuda(), torch.from_numpy(avail).cuda()
        ref = _rank1_block_t(Mt, av, j0, forced, mode == "finish")
        keep = torch.ones(m, dtype=torch.bool, device="cuda")
        if mode == "unforced":
            keep[ref[2]] = False
        scale = float(ref[0][:, keep].abs().max())
        times = {nm: [] for nm in names}
        for nm in turns(names):
            got = fns[nm](Mt, av, forced, j0)
            torch.cuda.synchronize()
            diff = float((ref[0] - got[0])[:, keep].abs().max())
            same = (torch.equal(ref[2], got[2].long())
                    and torch.equal(ref[1], got[1])
                    and torch.equal(ref[3], got[3] > 0))
            if not (same and diff <= 1e-12 * scale):
                msg = (f"K1 f64 {nm} [{w}, {m}] {mode}: disagrees (pivots "
                       f"and avail equal {same}, rel {diff / scale:.3e})")
                if not unchecked:
                    raise SystemExit(msg)
                print(msg + ", timed all the same (--unchecked)")
            times[nm].append(per_call_ms(fns[nm], Mt, av, forced, j0))
            del got
        t_lib = None
        if not forced:
            torch.backends.cuda.preferred_linalg_library("cusolver")
            t_lib = per_call_ms(torch.linalg.lu_factor, Mt.T)
            torch.backends.cuda.preferred_linalg_library("default")
        t_f32 = per_call_ms(cuda_panel.rank1_block_t, Mt.float(),
                            av.float(), forced, j0)
        r32 = cuda_panel.route(w, m, forced)
        # chip_smoke's bound: each input read and each output written
        # once over 3.35 TB/s, or the fp64 operations over 34 TFLOP/s
        bound = max((8.0 * (2 * w * m + 2 * m) + 8.0 * w) / 3.35e12,
                    (1.0 * w * (w - 1) * m + w * m) / 34e12) * 1e3
        for nm in names:
            best = min(times[nm])
            route = {1: "cluster", 2: "grid", 3: "tile"}.get(
                fns[nm].routes.get((w, m)), "?")
            lib = "none" if t_lib is None else f"{t_lib:.4f} ms"
            print(f"K1 f64 [{w}, {m}] {mode:8s} j0={j0:<5d} {nm:10s} "
                  f"({route}): {[round(t, 4) for t in times[nm]]} ms, best "
                  f"{best:.4f} ms ({best / w * 1e3:.2f} us per column); "
                  f"cuSOLVER f64 {lib}; f32 K1 ({r32}) {t_f32:.4f} ms; "
                  f"bound {bound:.4f} ms")
        del Mt, av, ref
        torch.cuda.empty_cache()


def ab_k3(libs, quick, unchecked=False):
    from conflux_tpu_torch.ops.gemm import _schur_update_t

    names = [n for n in libs if "schur_update" in libs[n]]
    fns = {n: schur_fn(libs[n]["schur_update"]) for n in names}
    shapes = K3_SHAPES[:1] if quick else K3_SHAPES
    for si, (tag, m, ncols, k, c0, c1) in enumerate(shapes):
        g = torch.Generator(device="cuda").manual_seed(500 + si)
        A = torch.randn(m, k, generator=g, device="cuda")
        B = torch.randn(k, c1 - c0, generator=g, device="cuda")
        R32 = torch.randn(m, ncols, generator=g, device="cuda")
        tol = 1e-5 * float(torch.mm(A.abs(), B.abs()).max())
        # the package's split pass alone, on both operands (hi and lo)
        t_split = (per_call_ms(cuda_gemm.split_hi_lo, A)
                   + per_call_ms(cuda_gemm.split_hi_lo, B))
        print(f"K3 {tag} split pass of A [{m}, {k}] and B [{k}, {c1 - c0}] "
              f"into hi and lo (package): {t_split:.3f} ms")
        for mode in ("high", "bf16", "bf16out"):
            R0 = R32.to(torch.bfloat16) if mode == "bf16out" else R32
            ref = _schur_update_t(R0.clone(), A, B, c0, mode, c1)[:, c0:c1]
            ref = ref.float()
            times = {nm: [] for nm in names}
            for nm in turns(names):
                got = fns[nm](R0.clone(), A, B, c0, mode, c1)
                torch.cuda.synchronize()
                d = (got[:, c0:c1].float() - ref).abs()
                if mode == "bf16out":
                    _, e = torch.frexp(ref)
                    ulp = torch.ldexp(torch.ones_like(ref), e - 8)
                    bad = int((d > ulp + tol).sum())
                else:
                    bad = int((d > tol).sum())
                if bad:
                    msg = (f"K3 {nm} {tag} {mode}: {bad} elements off the "
                           "plain version")
                    if not unchecked:
                        raise SystemExit(msg)
                    print(msg + ", timed all the same (--unchecked)")
                del got, d
                Rw = R0.clone()
                times[nm].append(per_call_ms(fns[nm], Rw, A, B, c0, mode, c1))
                del Rw
            flop = 2.0 * m * (c1 - c0) * k
            for nm in names:
                best = min(times[nm])
                print(f"K3 {tag} [{m} x {c1 - c0}, k {k}] {mode:7s} "
                      f"{nm:8s}: {[round(t, 3) for t in times[nm]]} ms, best "
                      f"{best:.3f} ms ({flop / best / 1e9:.1f} TFLOP/s of "
                      f"A@B)")
            del ref
        del A, B, R32
        torch.cuda.empty_cache()


def sass_histogram(libs, kernel: str):
    """Opcode counts of each build's `kernel` (a substring of its mangled
    name) in the SASS cuobjdump prints, most frequent first."""
    import collections
    import os
    import re

    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    for name in libs:
        for stem in libs[name]:
            so = OUT / f"lib{stem}-{name}.so"
            sass = subprocess.run([cuobjdump, "--dump-sass", str(so)],
                                  capture_output=True, text=True).stdout
            for part in sass.split("Function : ")[1:]:
                if kernel not in part.splitlines()[0]:
                    continue
                ops = collections.Counter(
                    m.group(1).split(".")[0] for m in re.finditer(
                        r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9.]*)",
                        part))
                total = sum(ops.values())
                print(f"SASS {name} {part.splitlines()[0].strip()[:60]}: "
                      f"{total} instructions, " + ", ".join(
                          f"{op} {n}" for op, n in ops.most_common(12)))


def turns(names):
    return list(names) + list(reversed(names))


def ab_k4(libs, quick):
    names = [n for n in libs if "bigk_gemm" in libs[n]]
    fns = {n: matmul_fn(libs[n]["bigk_gemm"]) for n in names}
    shapes = K4_SHAPES[:1] if quick else K4_SHAPES
    for si, (m, k, n) in enumerate(shapes):
        g = torch.Generator(device="cuda").manual_seed(1300 + si)
        A32 = torch.randn(m, k, generator=g, device="cuda")
        B32 = torch.randn(k, n, generator=g, device="cuda")
        for dtype in (torch.float32, torch.bfloat16):
            A, B = A32.to(dtype), B32.to(dtype)
            ref = torch.mm(A.float(), B.float())
            tol = 1e-5 * float(torch.mm(A.float().abs(),
                                        B.float().abs()).max())
            times = {nm: [] for nm in names}
            for nm in turns(names):
                got = fns[nm](A, B)
                torch.cuda.synchronize()
                diff = float((got - ref).abs().max())
                if not diff <= tol:
                    raise SystemExit(f"K4 {nm} [{m}, {k}, {n}] {dtype}: "
                                     f"max|diff| {diff} > {tol}")
                del got
                times[nm].append(per_call_ms(fns[nm], A, B))
            t_w = per_call_ms(cuda_gemm.matmul, A, B)
            print(f"K4 [{m}, {k}] @ [{k}, {n}] {str(dtype)[6:]:8s} "
                  f"package wrapper (ops/cuda_gemm.matmul): {t_w:.4f} ms")
            if dtype == torch.float32:
                t_l = per_call_ms(torch.mm, A, B)
            else:
                t_l = per_call_ms(lambda a, b: torch.mm(
                    a, b, out_dtype=torch.float32), A, B)
            flop = 2.0 * m * n * k
            for nm in names:
                best = min(times[nm])
                print(f"K4 [{m}, {k}] @ [{k}, {n}] {str(dtype)[6:]:8s} "
                      f"{nm:10s}: {[round(t, 4) for t in times[nm]]} ms, "
                      f"best {best:.4f} ms ({flop / best / 1e9:.1f} "
                      f"TFLOP/s), torch.mm {t_l:.4f} ms")
            del A, B, ref
        del A32, B32
        torch.cuda.empty_cache()


def ab_rows(libs, quick):
    names = [n for n in libs if "row_move" in libs[n]]
    g = torch.Generator(device="cuda").manual_seed(1400)
    R32 = torch.randn(N, N, generator=g, device="cuda")
    cases = [(torch.float32, "scatter", V, None),
             (torch.float32, "gather", V, None),
             (torch.bfloat16, "scatter", V, None),
             (torch.bfloat16, "gather", V, None),
             (torch.float32, "gather", N - V, (V, 2 * V))]
    if not quick:
        cases.insert(2, (torch.float32, "gather", N - V, None))
    for dtype, kind, w, cols in cases:
        R = R32 if dtype == torch.float32 else R32.to(dtype)
        if cols:
            R = R[:, cols[0]:cols[1]]
        idx = torch.randperm(N, generator=g, device="cuda")[:w]
        times = {nm: [] for nm in names}
        if kind == "gather":
            ref = R.index_select(0, idx)
            fns = {nm: row_move_fn(libs[nm]["row_move"], False)
                   for nm in names}
            args = (R, idx)
            t_l = per_call_ms(torch.index_select, R, 0, idx)
        else:
            src = torch.randn(w, N, generator=g, device="cuda").to(dtype)
            Rw = R.clone()
            ref = Rw.clone().index_copy_(0, idx, src)
            fns = {nm: row_move_fn(libs[nm]["row_move"], True)
                   for nm in names}
            args = (Rw, src, idx)
            t_l = per_call_ms(lambda r, s, i: r.index_copy_(0, i, s),
                              Rw.clone(), src, idx)
        for nm in turns(names):
            got = fns[nm](*args)
            torch.cuda.synchronize()
            if not torch.equal(got, ref):
                raise SystemExit(f"{kind} {nm} {w} rows {dtype}: differs")
            del got
            times[nm].append(per_call_ms(fns[nm], *args))
        wrapper = (cuda_scatter.gather_rows if kind == "gather" else
                   cuda_scatter.scatter_rows)
        print(f"{kind} {w} rows of width {R.shape[1]} {str(dtype)[6:]:8s} "
              f"package wrapper: {per_call_ms(wrapper, *args):.4f} ms")
        moved = 2.0 * w * R.shape[1] * R.element_size()
        for nm in names:
            best = min(times[nm])
            print(f"{kind} {w} rows of width {R.shape[1]} {str(dtype)[6:]:8s} "
                  f"{nm:10s}: {[round(t, 4) for t in times[nm]]} ms, best "
                  f"{best:.4f} ms ({moved / best / 1e6:.0f} GB/s), library "
                  f"{t_l:.4f} ms")
        del R, idx, ref, args
        torch.cuda.empty_cache()


def graph_ms(fn, *args, calls=20, reps=5):
    """Device milliseconds per call of fn(*args): `calls` calls captured in
    one CUDA graph, replayed between two events (no host launch work in
    the time); the median over `reps` replays."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn(*args)
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
    return sorted(times)[reps // 2]


def ab_trsm(libs, quick, unchecked=False):
    from conflux_tpu_torch.ops.panel import _pivot_solve_plain, select_pivots

    names = [n for n in libs if "panel_trsm" in libs[n]]
    fns = {n: trsm_fn(libs[n]["panel_trsm"]) for n in names}
    dtypes = (torch.float32,) if quick else (torch.float32, torch.float64)
    for r, n, group in TRSM_SHAPES:
        for dtype in dtypes:
            rng = np.random.default_rng(r + n)
            block = torch.from_numpy(rng.standard_normal((2 * n, n)))
            _, _, lu = select_pivots(block.to(dtype), torch.ones(
                2 * n, dtype=torch.bool), n, block=128)
            L64 = torch.tril(lu.double(), -1) + torch.eye(n,
                                                          dtype=torch.float64)
            kappa = float(L64.abs().sum(1).max()
                          * torch.linalg.inv(L64).abs().sum(1).max())
            lu = lu.T.contiguous().cuda().T
            B = torch.from_numpy(rng.standard_normal((r, n))).to("cuda",
                                                                 dtype)
            ref = _pivot_solve_plain(B, lu, group)
            tol = 2 * torch.finfo(dtype).eps * kappa * float(B.abs().max())
            times = {nm: [] for nm in names}
            for nm in turns(names):
                got = fns[nm](B, lu)
                torch.cuda.synchronize()
                diff = float((got - ref).abs().max())
                if not diff <= tol:
                    msg = (f"panel_trsm {nm} [{r}, {n}] {dtype}: max|diff| "
                           f"{diff} > {tol}")
                    if not unchecked:
                        raise SystemExit(msg)
                    print(msg + ", timed all the same (--unchecked)")
                times[nm].append(per_call_ms(fns[nm], B, lu))
            device = {nm: graph_ms(fns[nm], B, lu) for nm in names}
            L = L64.to("cuda", dtype)
            t_w = per_call_ms(cuda_trsm.solve_unit_lower_t, B, lu)
            t_p = per_call_ms(_pivot_solve_plain, B, lu, group)
            def library(b):
                return torch.linalg.solve_triangular(
                    L.T, b, upper=True, left=False, unitriangular=True)

            t_l = per_call_ms(library, B)
            d_p = graph_ms(_pivot_solve_plain, B, lu, group)
            d_l = graph_ms(library, B)
            tag = f"panel_trsm [{r}, {n}] {str(dtype)[6:]:8s}"
            print(f"{tag} package wrapper {t_w:.4f} ms, plain "
                  f"({'group' if group else 'block'} chain) {t_p:.4f} ms "
                  f"(device {d_p:.4f}), torch.linalg.solve_triangular "
                  f"{t_l:.4f} ms (device {d_l:.4f})")
            for nm in names:
                print(f"{tag} {nm:10s}: {[round(t, 4) for t in times[nm]]} "
                      f"ms, best {min(times[nm]):.4f} ms, device "
                      f"{device[nm]:.4f} ms")
            del B, lu, ref


def host_overhead():
    """Host microseconds per call of each package wrapper and of the
    library call, on inputs too small for the device to matter."""
    import time

    R = torch.randn(64, 64, device="cuda")
    idx = torch.arange(16, device="cuda")
    a = torch.randn(64, 64, device="cuda").bfloat16()
    av = torch.ones(1, 64, device="cuda")
    cases = {"rank1_block_t": (cuda_panel.rank1_block_t, (R[:8].clone(), av)),
             "gather_rows": (cuda_scatter.gather_rows, (R, idx)),
             "index_select": (torch.index_select, (R, 0, idx)),
             "matmul bf16": (cuda_gemm.matmul, (a, a)),
             "sub_matmul_bigk_bf16": (cuda_gemm.sub_matmul_bigk_bf16,
                                      (R, a, a, "bf16")),
             "sub_matmul_bigk_bf16 B^T": (cuda_gemm.sub_matmul_bigk_bf16,
                                          (R, a, a.T, "bf16")),
             "torch.mm bf16": (lambda x, y: torch.mm(
                 x, y, out_dtype=torch.float32), (a, a)),
             "solve_unit_lower_t": (cuda_trsm.solve_unit_lower_t,
                                    (R[:8].clone(), R.T))}
    for name, (fn, args) in cases.items():
        for _ in range(20):
            fn(*args)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            fn(*args)
        torch.cuda.synchronize()
        print(f"host overhead {name}: "
              f"{(time.perf_counter() - t0) / 200 * 1e6:.1f} us per call")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--lib", action="append", required=True,
                    help="name=directory holding some of " + ", ".join(
                        f"{s}.cu" for s in STEMS))
    ap.add_argument("--quick", action="store_true",
                    help="fewer shapes of each kernel")
    ap.add_argument("--only", action="append",
                    choices=("k1", "k1f64", "k2", "k2bf16", "k3", "k4",
                             "rows", "trsm"),
                    help="run only these kernels' A/B (repeatable)")
    ap.add_argument("--steps", action="store_true",
                    help="K2 against its plain version at the step shapes "
                    "of a crout and a Cholesky factorization (with --only "
                    "k2bf16 alone: the bf16 entry at the bf16 paths' step "
                    "shapes)")
    ap.add_argument("--unchecked", action="store_true",
                    help="K1, K1 in double, K3, trsm: time builds that disagree with the plain "
                    "version (variants that leave out work, to attribute "
                    "time)")
    ap.add_argument("--sass", action="append", default=[],
                    help="print each build's opcode counts of this kernel")
    args = ap.parse_args()
    libs = build(dict(spec.split("=", 1) for spec in args.lib))
    for kernel in args.sass:
        sass_histogram(libs, kernel)
    host_overhead()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"card: {smi}")
    only = set(args.only or ("k1", "k1f64", "k2", "k2bf16", "k3", "k4",
                             "rows", "trsm"))
    if "k1" in only:
        ab_k1(libs, args.quick, args.unchecked)
    if "k1f64" in only:
        ab_k1f64(libs, args.quick, args.unchecked)
    if "k3" in only:
        ab_k3(libs, args.quick, args.unchecked)
    for key, fn in (("k2", ab_k2), ("k4", ab_k4), ("rows", ab_rows)):
        if key in only:
            fn(libs, args.quick)
    if "trsm" in only:
        ab_trsm(libs, args.quick, args.unchecked)
    if "k2bf16" in only:
        ab_k2bf16(libs, args.quick, args.steps)
    if args.steps and only != {"k2bf16"}:
        path_steps()


if __name__ == "__main__":
    main()
