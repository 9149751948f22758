"""Where K1's time per column goes, by the SM's own clock.

    python3 -m experiments.torch_k1_phases

Builds an instrumented copy of conflux_tpu_torch/csrc/rank1_panel.cu into
the gitignored _ab/build/: clock64() reads around the four parts of each
column's step in the cluster route's kernel (the exchange that finds the
pivot, the multipliers and row jj+1's update with the next search, the
next candidate's reduction and push to the peers, the rest of the
update), summed over the columns by threads 0 and 32 of the last CTA,
and around the grid route's kernel's (argmax, publication with the grid
barrier, reduction with the winner's column, update), by threads 0 and
32 of CTA 0, read back through a device array. Then runs search blocks
on both routes and prints cycles per column per part,
beside the kernel's time per column (timing.per_call_ms) and the card's
name and power limit. The copy is patched by exact string anchors and
fails loudly if an anchor is missing.
"""

import ctypes
import subprocess
from pathlib import Path

import numpy as np
import torch

from conflux_tpu_torch.ops import _build
from conflux_tpu_torch.timing import per_call_ms

ROOT = Path(__file__).resolve().parent.parent
OUT = ROOT / "_ab" / "build"
# search blocks on the cluster route and on the grid route
CASES = ((128, 1000, False, 0), (128, 2048, False, 0),
         (128, 17408, False, 0), (128, 32768, False, 0))
PARTS = ("exchange", "multipliers+search", "reduce+publish", "rest of update")

PATCHES = [
    ("  for (int jj = 0; jj < w; ++jj) {\n    const int p = exchange(jj);\n",
     "  long long prof[4] = {0, 0, 0, 0};\n"
     "  for (int jj = 0; jj < w; ++jj) {\n    long long t0 = clock64();\n"
     "    const int p = exchange(jj);\n    long long t1 = clock64();\n"
     "    prof[0] += t1 - t0;\n"),
    ("    if (more) local_best(next, jj + 1, best, bi);\n    __syncthreads();\n",
     "    if (more) local_best(next, jj + 1, best, bi);\n    __syncthreads();\n"
     "    long long t2 = clock64();\n    prof[1] += t2 - t1;\n"),
    ("    // the candidate's column was read from the slab before the rest of\n"
     "    // the update changes it\n    __syncthreads();\n",
     "    // the candidate's column was read from the slab before the rest of\n"
     "    // the update changes it\n    __syncthreads();\n"
     "    long long t3 = clock64();\n    prof[2] += t3 - t2;\n"),
    ("        *e = __fsub_rn(*e, __fmul_rn(pc[r], mu));\n      }\n    }\n  }\n",
     "        *e = __fsub_rn(*e, __fmul_rn(pc[r], mu));\n      }\n    }\n"
     "    prof[3] += clock64() - t3;\n  }\n"
     "  if (blockIdx.x == G - 1 && (tid == 0 || tid == 32))\n"
     "    for (int q = 0; q < 4; ++q) g_prof[(tid / 32) * 4 + q] = prof[q];\n"),
    ("__global__ void __launch_bounds__(kThreads, 1) rank1_cluster_kernel(",
     "__device__ long long g_prof[8];\n\n"
     "__global__ void __launch_bounds__(kThreads, 1) rank1_cluster_kernel("),
    ('extern "C" {\n',
     'extern "C" {\n\nint conflux_k1_prof(long long* out) {\n'
     '  return cudaMemcpyFromSymbol(out, g_prof, sizeof(g_prof));\n}\n\n'),
]


# the grid route's kernel: argmax, publication and the grid barrier, the
# reduction and the winner's column, the update
GRID_PATCHES = [
    ("  for (int jj = 0; jj < w; ++jj) {\n    float* row = slab + jj * ld;\n",
     "  long long gprof[4] = {0, 0, 0, 0};\n"
     "  for (int jj = 0; jj < w; ++jj) {\n    long long t0 = clock64();\n"
     "    float* row = slab + jj * ld;\n"),
    ("    // 2. publish it with its column values (rows jj..w-1), L2 only: the\n",
     "    long long t1 = clock64();\n    gprof[0] += t1 - t0;\n"
     "    // 2. publish it with its column values (rows jj..w-1), L2 only: the\n"),
    ("    // 4. every CTA reduces the candidates in the same order\n",
     "    long long t2 = clock64();\n    gprof[1] += t2 - t1;\n"
     "    // 4. every CTA reduces the candidates in the same order\n"),
    ("    // 5. rank-1 update of this CTA's available, non-pivot lanes\n",
     "    long long t3 = clock64();\n    gprof[2] += t3 - t2;\n"
     "    // 5. rank-1 update of this CTA's available, non-pivot lanes\n"),
    ("        *x = __fsub_rn(*x, __fmul_rn(pcol[r], mu));\n      }\n    }\n"
     "    __syncthreads();\n  }\n",
     "        *x = __fsub_rn(*x, __fmul_rn(pcol[r], mu));\n      }\n    }\n"
     "    __syncthreads();\n    gprof[3] += clock64() - t3;\n  }\n"
     "  if (blockIdx.x == 0 && (tid == 0 || tid == 32))\n"
     "    for (int q = 0; q < 4; ++q) g_prof[(tid / 32) * 4 + q] = gprof[q];\n"),
]
GRID_PARTS = ("argmax", "publish+grid barrier", "reduce+column", "update")


def build():
    src = (_build._CSRC / "rank1_panel.cu").read_text()
    for old, new in PATCHES + GRID_PATCHES:
        if src.count(old) != 1:
            raise SystemExit(f"anchor not found once: {old!r}")
        src = src.replace(old, new)
    OUT.mkdir(parents=True, exist_ok=True)
    cu = OUT / "rank1_panel_prof.cu"
    cu.write_text(src)
    so = OUT / "librank1_panel_prof.so"
    subprocess.run([_build._nvcc(), *_build._FLAGS, f"-I{_build._CSRC}",
                    "-o", str(so), str(cu)], check=True,
                   capture_output=True, text=True)
    return ctypes.CDLL(str(so))


def main():
    lib = build()
    p, i = ctypes.c_void_p, ctypes.c_int
    f = lib.conflux_rank1_panel
    f.argtypes = [p, p, p, p, p, p, p, i, i, i, i, p, ctypes.POINTER(i)]
    f.restype = i
    lib.conflux_rank1_panel_scratch_floats.argtypes = [i]
    lib.conflux_rank1_panel_scratch_floats.restype = i
    prof = (ctypes.c_longlong * 8)()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"card: {smi}")
    for w, m, forced, j0 in CASES:
        rng = np.random.default_rng(m)
        A = rng.standard_normal((w, m)).astype(np.float32)
        if forced:
            A[np.arange(w), j0 + np.arange(w)] += w
        avail = np.ones((1, m), np.float32)
        avail[0, :j0] = 0.0
        Mt, av = torch.from_numpy(A).cuda(), torch.from_numpy(avail).cuda()
        out, avo = torch.empty_like(Mt), torch.empty_like(av)
        piv = torch.empty(w, dtype=torch.int32, device="cuda")
        ok = torch.empty_like(piv)
        scratch = torch.empty(lib.conflux_rank1_panel_scratch_floats(w),
                              device="cuda")
        route = ctypes.c_int(-1)

        def run():
            err = f(Mt.data_ptr(), av.data_ptr(), out.data_ptr(),
                    avo.data_ptr(), piv.data_ptr(), ok.data_ptr(),
                    scratch.data_ptr(), w, m, int(forced), j0,
                    torch.cuda.current_stream().cuda_stream,
                    ctypes.byref(route))
            if err:
                raise RuntimeError(f"conflux_rank1_panel error {err}")

        ms = per_call_ms(run)
        torch.cuda.synchronize()
        if lib.conflux_k1_prof(prof):
            raise RuntimeError("reading the clock sums failed")
        name = {1: "cluster", 2: "grid"}.get(route.value, str(route.value))
        names = GRID_PARTS if name == "grid" else PARTS
        for t, who in ((0, "thread 0"), (1, "thread 32")):
            parts = ", ".join(f"{n} {prof[4 * t + q] / w:.0f}"
                              for q, n in enumerate(names))
            print(f"K1 [{w}, {m}] {'forced' if forced else 'search'} "
                  f"({name}): {ms / w * 1e3:.2f} us per column; {who}: "
                  f"cycles per column: {parts}")


if __name__ == "__main__":
    main()
