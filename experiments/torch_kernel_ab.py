"""A/B of K4 (bigk_gemm.cu) and K5/K6 (row_move.cu) builds in one call.

    python3 -m experiments.torch_kernel_ab --lib old=_ab/old \
        --lib new=conflux_tpu_torch/csrc [--lib name=dir ...] [--quick]

Each --lib names a directory holding a bigk_gemm.cu and/or a row_move.cu
(with the csrc/ headers they include, or beside csrc/, whose headers are
on the include path too). Every source is built by its own nvcc with the
port's flags (ops/_build._FLAGS), all at once, into the gitignored
_ab/build/, and loaded with ctypes. An earlier commit's sources go into a
gitignored directory with `git show <commit>:conflux_tpu_torch/csrc/...`.
Both C interfaces are taken: the present one, which reports the route
through a last int* argument, and the earlier one, which had none.

Then, on the card, each build's kernels run at chip_smoke.py's shapes: K4
at the three prof_pallas_gemm shapes for f32 and bf16, K5/K6 at the
[32768, 32768] row moves and the split path's panel gather. Builds take
turns per shape (a, b, ..., b, a), each timed as timing.per_call_ms
(back-to-back calls between two events), and every result is compared
with the plain version (K4 within 1e-5 of max(|A|@|B|), K5/K6 bit for
bit). Prints one line per shape and build, and the card's name and power
limit.
"""

import argparse
import ctypes
import subprocess
from pathlib import Path

import torch

from conflux_tpu_torch.ops import _build, cuda_gemm, cuda_scatter
from conflux_tpu_torch.timing import per_call_ms

ROOT = Path(__file__).resolve().parent.parent
OUT = ROOT / "_ab" / "build"
K4_SHAPES = ((16384, 512, 16384), (8192, 1024, 8192), (8192, 8192, 8192))
N, V = 32768, 1536


def build(libs):
    """{name: {source stem: CDLL}} for each --lib directory."""
    OUT.mkdir(parents=True, exist_ok=True)
    jobs = []
    for name, d in libs.items():
        for stem in ("bigk_gemm", "row_move"):
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


def host_overhead():
    """Host microseconds per call of each package wrapper and of the
    library call, on inputs too small for the device to matter."""
    import time

    R = torch.randn(64, 64, device="cuda")
    idx = torch.arange(16, device="cuda")
    a = torch.randn(64, 64, device="cuda").bfloat16()
    cases = {"gather_rows": (cuda_scatter.gather_rows, (R, idx)),
             "index_select": (torch.index_select, (R, 0, idx)),
             "matmul bf16": (cuda_gemm.matmul, (a, a)),
             "torch.mm bf16": (lambda x, y: torch.mm(
                 x, y, out_dtype=torch.float32), (a, a))}
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
                    help="name=directory holding bigk_gemm.cu / row_move.cu")
    ap.add_argument("--quick", action="store_true",
                    help="one K4 shape and no 31232-row full gather")
    ap.add_argument("--only", choices=("k4", "rows"))
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
    if args.only != "rows":
        ab_k4(libs, args.quick)
    if args.only != "k4":
        ab_rows(libs, args.quick)


if __name__ == "__main__":
    main()
