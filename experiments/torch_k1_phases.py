"""Where K1's time per column goes, by the SM's own clock.

    python3 -m experiments.torch_k1_phases [--csrc DIR]

Builds an instrumented copy of DIR/rank1_panel.cu (default: the
package's csrc/) into the gitignored _ab/build/: clock64() reads around
the parts of each column's step, summed over the columns and read back
through a device array. In the cluster route's kernel: the exchange that
finds the pivot, the multipliers and row jj+1's update with the next
search, the next candidate's reduction and push to the peers, the rest
of the update (threads 0 and 32 of the last CTA). In the flat grid
route's kernel: the local search, publication with the grid barrier, the
records' reduction, the winner's column, the update (threads 0 and 32 of
CTA 0). In the clustered grid route's kernel: the chain's parts in CTA 0
(a leader) and CTA 1 (not one) by thread 0, and the update warps' wait
and work by thread 128 of CTA 0. Each kernel's patches apply where its
first anchor is in the source (so an earlier commit's copy is
instrumented as far as it has those kernels), and every anchor of an
applied kernel must be found once. Then runs search blocks on every
route and prints cycles per column per part beside the kernel's time per
column (timing.per_call_ms) and the card's name and power limit.
"""

import argparse
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
         (128, 2176, False, 0), (128, 16384, False, 0),
         (128, 17408, False, 0), (128, 32768, False, 0),
         (64, 8192, False, 0), (64, 32768, False, 0))
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
     "    for (int q = 0; q < 4; ++q) g_prof[(tid / 32) * 8 + q] = prof[q];\n"),
    ("__global__ void __launch_bounds__(kThreads, 1) rank1_cluster_kernel(",
     "__device__ long long g_prof[64];\n\n"
     "__global__ void __launch_bounds__(kThreads, 1) rank1_cluster_kernel("),
    ('extern "C" {\n',
     'extern "C" {\n\nint conflux_k1_prof(long long* out) {\n'
     '  return cudaMemcpyFromSymbol(out, g_prof, sizeof(g_prof));\n}\n\n'),
]


# the grid route's kernel: argmax, publication and the grid barrier, the
# reduction and the winner's column, the update
GRID_PATCHES = [
    ("  for (int jj = 0; jj < w; ++jj) {\n    float* row = slab + jj * ld;\n",
     "  long long gprof[5] = {0, 0, 0, 0, 0};\n"
     "  for (int jj = 0; jj < w; ++jj) {\n    long long t0 = clock64();\n"
     "    float* row = slab + jj * ld;\n"),
    ("    // 2. publish it with its column values (rows jj..w-1), L2 only: the\n",
     "    long long t1 = clock64();\n    gprof[0] += t1 - t0;\n"
     "    // 2. publish it with its column values (rows jj..w-1), L2 only: the\n"),
    ("    // 4. every CTA reduces the candidates in the same order\n",
     "    long long t2 = clock64();\n    gprof[1] += t2 - t1;\n"
     "    // 4. every CTA reduces the candidates in the same order\n"),
    ("      if (tid == 0) win_cta = c;\n    }\n    __syncthreads();\n",
     "      if (tid == 0) win_cta = c;\n    }\n    __syncthreads();\n"
     "    long long t2b = clock64();\n    gprof[2] += t2b - t2;\n"),
    ("    // 5. rank-1 update of this CTA's available, non-pivot lanes\n",
     "    long long t3 = clock64();\n    gprof[3] += t3 - t2b;\n"
     "    // 5. rank-1 update of this CTA's available, non-pivot lanes\n"),
    ("        *x = __fsub_rn(*x, __fmul_rn(pcol[r], mu));\n      }\n    }\n"
     "    __syncthreads();\n  }\n",
     "        *x = __fsub_rn(*x, __fmul_rn(pcol[r], mu));\n      }\n    }\n"
     "    __syncthreads();\n    gprof[4] += clock64() - t3;\n  }\n"
     "  if (blockIdx.x == 0 && (tid == 0 || tid == 32))\n"
     "    for (int q = 0; q < 5; ++q) g_prof[(tid / 32) * 8 + q] = gprof[q];\n"),
]
GRID_PARTS = ("argmax", "publish+grid barrier", "record reduce",
              "winner's column", "update")

# the clustered grid route's kernel: each stamp adds the cycles since the
# one before it to its part
CHAIN_PARTS = ("wait for the cluster's candidates", "reduce + slot store",
               "L2 round", "pivot reduce", "multipliers, row c+1, own search",
               "CTA reduce", "wait for the update", "retire + publish")
BULK_PARTS = ("update warps' wait", "update warps' work")


def _stamp(k, arr="cprof"):
    return (f"{{ const long long _t = clock64(); {arr}[{k}] += _t - "
            f"{arr}_last; {arr}_last = _t; }}\n")


CLUSTERED_PATCHES = [
    ("    const uint32_t epoch = ld_u32(a.epoch);\n",
     "    const uint32_t epoch = ld_u32(a.epoch);\n"
     "    long long cprof[8] = {0, 0, 0, 0, 0, 0, 0, 0};\n"
     "    long long cprof_last = clock64();\n"),
    ("      mbar_wait_cluster(&gbar[buf], (c >> 1) & 1);\n",
     "      mbar_wait_cluster(&gbar[buf], (c >> 1) & 1);\n      " + _stamp(0)),
    ("        mbar_expect_tx(&gbar[buf], kGridCluster * col_words(c + 2) * 16);"
     "\n    };\n",
     "        mbar_expect_tx(&gbar[buf], kGridCluster * col_words(c + 2) * 16);"
     "\n      " + _stamp(1) + "    };\n"),
    ("      bar_sync(kBarChain, kChain);\n      const uint64_t k = lane < ncl",
     "      bar_sync(kBarChain, kChain);\n      " + _stamp(2)
     + "      const uint64_t k = lane < ncl"),
    ("      return p;\n    };\n\n    {\n",
     "      " + _stamp(3) + "      return p;\n    };\n\n    {\n"),
    ("      if (more) key = cta_key(key, c + 1);\n",
     "      " + _stamp(4) + "      if (more) key = cta_key(key, c + 1);\n"
     "      " + _stamp(5)),
    ("      if (c > 0) bar_sync(kBarDone, kGridThreads);\n",
     "      if (c > 0) bar_sync(kBarDone, kGridThreads);\n      " + _stamp(6)),
    ("      push_word(c + 1, off, v);\n    }\n"
     "    bar_sync(kBarDone, kGridThreads);    // the last column's update\n",
     "      push_word(c + 1, off, v);\n      " + _stamp(7) + "    }\n"
     "    bar_sync(kBarDone, kGridThreads);    // the last column's update\n"
     "    if (blockIdx.x < 2 && tid == 0)\n"
     "      for (int q = 0; q < 8; ++q) g_prof[16 * (blockIdx.x + 1) + q] = "
     "cprof[q];\n"),
    ("    for (int c = 0; c < w; ++c) {\n      bar_sync(kBarStart, kGridThreads);\n"
     "      const float* pc = stage + pcol_at[c & 1];\n",
     "    long long bprof[2] = {0, 0};\n    long long bprof_last = clock64();\n"
     "    for (int c = 0; c < w; ++c) {\n      bar_sync(kBarStart, kGridThreads);\n"
     "      " + _stamp(0, "bprof") +
     "      const float* pc = stage + pcol_at[c & 1];\n"),
    ("      bar_arrive(kBarDone, kGridThreads);\n    }\n  } else {\n",
     "      " + _stamp(1, "bprof") +
     "      bar_arrive(kBarDone, kGridThreads);\n    }\n"
     "    if (blockIdx.x == 0 && tid == kChain)\n"
     "      for (int q = 0; q < 2; ++q) g_prof[48 + q] = bprof[q];\n"
     "  } else {\n"),
]


def build(csrc: Path):
    src = (csrc / "rank1_panel.cu").read_text()
    for patches in (PATCHES, GRID_PATCHES, CLUSTERED_PATCHES):
        if patches[0][0] not in src:
            continue
        for old, new in patches:
            if src.count(old) != 1:
                raise SystemExit(f"anchor not found once: {old!r}")
            src = src.replace(old, new)
    OUT.mkdir(parents=True, exist_ok=True)
    cu = OUT / "rank1_panel_prof.cu"
    cu.write_text(src)
    so = OUT / "librank1_panel_prof.so"
    subprocess.run([_build._nvcc(), *_build._FLAGS, f"-I{csrc}",
                    "-o", str(so), str(cu)], check=True,
                   capture_output=True, text=True)
    return ctypes.CDLL(str(so))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--csrc", type=Path, default=_build._CSRC,
                    help="directory of the rank1_panel.cu to instrument")
    lib = build(ap.parse_args().csrc)
    p, i = ctypes.c_void_p, ctypes.c_int
    f = lib.conflux_rank1_panel
    # the present interface; an earlier one ignores the last pointers
    f.argtypes = [p, p, p, p, p, p, p, i, i, i, i, p, ctypes.POINTER(i),
                  ctypes.POINTER(i)]
    f.restype = i
    lib.conflux_rank1_panel_scratch_floats.argtypes = [i]
    lib.conflux_rank1_panel_scratch_floats.restype = i
    prof = (ctypes.c_longlong * 64)()
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
        scratch = torch.zeros(lib.conflux_rank1_panel_scratch_floats(w),
                              device="cuda")
        route, cluster = ctypes.c_int(-1), ctypes.c_int(0)

        def run():
            err = f(Mt.data_ptr(), av.data_ptr(), out.data_ptr(),
                    avo.data_ptr(), piv.data_ptr(), ok.data_ptr(),
                    scratch.data_ptr(), w, m, int(forced), j0,
                    torch.cuda.current_stream().cuda_stream,
                    ctypes.byref(route), ctypes.byref(cluster))
            if err:
                raise RuntimeError(f"conflux_rank1_panel error {err}")

        ms = per_call_ms(run)
        torch.cuda.synchronize()
        if lib.conflux_k1_prof(prof):
            raise RuntimeError("reading the clock sums failed")
        name = {1: "cluster", 2: "grid"}.get(route.value, str(route.value))
        tag = f"K1 [{w}, {m}] {'forced' if forced else 'search'}"
        if name == "grid" and cluster.value > 1:
            rows = ((16, CHAIN_PARTS, f"clusters of {cluster.value}; CTA 0 "
                     "(leader), chain thread 0"),
                    (32, CHAIN_PARTS, "CTA 1, chain thread 0"),
                    (48, BULK_PARTS, "CTA 0, update thread 128"))
        else:
            names = GRID_PARTS if name == "grid" else PARTS
            rows = ((0, names, "thread 0"), (8, names, "thread 32"))
        for at, names, who in rows:
            parts = ", ".join(f"{n} {prof[at + q] / w:.0f}"
                              for q, n in enumerate(names))
            print(f"{tag} ({name}): {ms / w * 1e3:.2f} us per column; {who}: "
                  f"cycles per column: {parts}")


if __name__ == "__main__":
    main()
