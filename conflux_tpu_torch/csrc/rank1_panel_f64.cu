// K1 in double: the masked-argmax partial-pivoting rank-1 elimination of a
// transposed float64 panel block, by hand for Hopper (sm_90a).
//
// Replaces the TPU kernel conflux_tpu/ops/pallas_panel.py:_rank1_kernel
// (wrapper rank1_block_pallas_t) for the float64 panels of the JAX
// package's x64 mode. Same contract as the float32 K1 (rank1_panel.cu):
//   Mt [w, m] f64 (panel columns as rows, matrix rows as lanes),
//   avail [1, m] f64 (> 0 = selectable)
//   -> Mt' [w, m], avail' [1, m], piv [w] i32, ok [w] i32.
// For each column jj in order: pick the available lane p of largest |Mt[jj]|
// (lowest lane on ties, NaN ranks highest, as jnp.argmax), or p = j0 + jj
// in forced mode; store col / pivot (a true division; a zero pivot divides
// by 1) as the multipliers of the other available lanes in row jj; update
// rows jj+1..w-1 of those lanes by the rank-1 product x - pivcol * mult,
// the product rounded before the subtraction (no fused multiply-add);
// retire lane p. Pivot lanes keep the merged-factor values they held when
// selected, which is what the forced and finish modes ask for, so all
// three modes run the same code.
//
// What bounds it on the H100: latency, as for the float32 kernel. The w
// columns form a chain of exchanges between the CTAs that hold the lanes;
// the bytes (32 MiB at [128, 32768]) would take 10 us, the card's 67
// TFLOP/s of fp64 FMA ~2 us. One route serves every shape: the float32
// kernel's grid route, in double. One persistent cooperative launch, one
// CTA per SM with ~256 lanes; per column each CTA publishes its candidate
// lane with that lane's column values, one grid barrier makes them
// visible, and every CTA reduces the candidates in the same order, so all
// agree on the pivot. A CTA keeps its [w, lanes] slab in shared memory
// where it fits (up to 224 lanes at w = 128, so blocks of up to ~29.5k
// lanes on 132 SMs) and works on the output in
// global memory, through the L2, where it does not. The float32 kernel's
// cluster and tile routes pack a pivot index into a 4-byte word and size
// their scratch in floats; they have no double version yet.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <climits>
#include <cmath>
#include <mutex>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLanesPerCta = 256;   // lanes a CTA aims to own
constexpr int kMaxGrid = 1024;      // bound of the scratch layout
constexpr int kHead = 4;            // score, lane, avail[lane], pad
constexpr int kMaxDevices = 64;
constexpr int kRouteGrid = 2;       // rank1_panel.cu's numbering

// argmax order: larger score wins, NaN beats any number, lower lane on ties
__device__ __forceinline__ bool better(double a, int ia, double b, int ib) {
  const bool na = isnan(a), nb = isnan(b);
  if (na || nb) return na && (!nb || ia < ib);
  return a > b || (a == b && ia < ib);
}

__device__ __forceinline__ void warp_best(double& s, int& i, int& c) {
  for (int off = 16; off > 0; off >>= 1) {
    const double os = __shfl_down_sync(0xffffffffu, s, off);
    const int oi = __shfl_down_sync(0xffffffffu, i, off);
    const int oc = __shfl_down_sync(0xffffffffu, c, off);
    if (better(os, oi, s, i)) {
      s = os;
      i = oi;
      c = oc;
    }
  }
}

struct Args {
  const double* mt_in;
  const double* avail_in;
  double* mt_out;
  double* avail_out;
  int* piv;
  int* ok;
  double* head;   // [2][grid][kHead] candidate records, double-buffered
  double* cols;   // [2][grid][w] each candidate lane's column values
  int w;
  int m;
  int lanes;      // lanes per CTA
  int forced;
  int j0;
};

// dynamic shared memory of a CTA: the slab with an odd row stride (if it
// fits), avail, and the pivot column
size_t smem_bytes(int w, int lanes, bool slab) {
  return ((slab ? (size_t)w * (lanes | 1) : 0) + lanes + w) * sizeof(double);
}

template <bool kSlab>
__global__ void __launch_bounds__(kThreads, 1) rank1_f64_kernel(Args a) {
  extern __shared__ double smem[];
  __shared__ double red_s[kWarps];
  __shared__ int red_i[kWarps];
  __shared__ int win_cta;

  const int w = a.w, m = a.m, L = a.lanes;
  const int G = gridDim.x;
  const int tid = threadIdx.x;
  const int lane0 = blockIdx.x * L;
  const int nl = min(L, m - lane0);  // >= 1: the host sizes the grid so

  // the slab holds this CTA's [w, nl] lanes: shared memory with row stride
  // L | 1, or the output block itself with row stride m
  double* slab;
  size_t ld;
  double* avail_s;
  if (kSlab) {
    slab = smem;
    ld = L | 1;
    avail_s = smem + (size_t)w * ld;
  } else {
    slab = a.mt_out + lane0;
    ld = m;
    avail_s = smem;
  }
  double* pcol = avail_s + L;  // [w] pivot lane's column values

  for (int r = 0; r < w; ++r)
    for (int i = tid; i < nl; i += kThreads)
      slab[r * ld + i] = a.mt_in[(size_t)r * m + lane0 + i];
  for (int i = tid; i < nl; i += kThreads) avail_s[i] = a.avail_in[lane0 + i];
  __syncthreads();

  cg::grid_group grid = cg::this_grid();

  for (int jj = 0; jj < w; ++jj) {
    double* row = slab + jj * ld;

    // 1. this CTA's candidate: masked |x| argmax over its lanes
    const int fp = a.j0 + jj;
    double best = -INFINITY;
    int bi = INT_MAX;
    for (int i = tid; i < nl; i += kThreads) {
      const int gi = lane0 + i;
      double s;
      if (a.forced)
        s = gi == fp ? INFINITY : -INFINITY;
      else
        s = avail_s[i] > 0.0 ? fabs(row[i]) : -INFINITY;
      if (better(s, gi, best, bi)) {
        best = s;
        bi = gi;
      }
    }
    int unused = 0;
    warp_best(best, bi, unused);
    if ((tid & 31) == 0) {
      red_s[tid >> 5] = best;
      red_i[tid >> 5] = bi;
    }
    __syncthreads();
    // every warp reduces the warps' candidates itself (a real lane of this
    // CTA: nl >= 1 and -inf ties go low)
    best = red_s[tid % kWarps];
    bi = red_i[tid % kWarps];
    warp_best(best, bi, unused);
    best = __shfl_sync(0xffffffffu, best, 0);
    bi = __shfl_sync(0xffffffffu, bi, 0);

    // 2. publish it with its column values (rows jj..w-1), L2 only: the
    // records are rewritten every other column, and L1 is not coherent.
    // The lane index travels as a double (exact below 2^53).
    const int buf = jj & 1;
    const int li = bi - lane0;
    double* head = a.head + ((size_t)buf * G + blockIdx.x) * kHead;
    double* cbuf = a.cols + ((size_t)buf * G + blockIdx.x) * w;
    for (int r = jj + tid; r < w; r += kThreads)
      __stcg(cbuf + r, slab[r * ld + li]);
    if (tid == 0) {
      __stcg(head + 0, best);
      __stcg(head + 1, static_cast<double>(bi));
      __stcg(head + 2, avail_s[li]);
    }

    // 3. one barrier per column. Double-buffered records are safe: a CTA
    // rewrites buffer `buf` only after the next barrier, which every CTA
    // reaches only after it has read this column's records.
    if (G > 1)
      grid.sync();
    else
      __syncthreads();

    // 4. every CTA reduces the candidates in the same order
    if (tid < 32) {
      double s = -INFINITY;
      int i = INT_MAX, c = 0;
      for (int k = tid; k < G; k += 32) {
        const double* h = a.head + ((size_t)buf * G + k) * kHead;
        const double ks = __ldcg(h);
        const int ki = static_cast<int>(__ldcg(h + 1));
        if (better(ks, ki, s, i)) {
          s = ks;
          i = ki;
          c = k;
        }
      }
      warp_best(s, i, c);
      if (tid == 0) win_cta = c;
    }
    __syncthreads();
    const double* wh = a.head + ((size_t)buf * G + win_cta) * kHead;
    const double* wcol = a.cols + ((size_t)buf * G + win_cta) * w;
    const int p = static_cast<int>(__ldcg(wh + 1));
    const double pv = __ldcg(wcol + jj);
    for (int r = jj + 1 + tid; r < w; r += kThreads) pcol[r] = __ldcg(wcol + r);
    if (blockIdx.x == 0 && tid == 0) {
      a.piv[jj] = p;
      a.ok[jj] = __ldcg(wh + 2) > 0.0 ? 1 : 0;
    }
    __syncthreads();

    // 5. rank-1 update of this CTA's available, non-pivot lanes
    const double safe = pv == 0.0 ? 1.0 : pv;
    for (int i = tid; i < nl; i += kThreads) {
      if (lane0 + i == p) {
        avail_s[i] = 0.0;
        continue;
      }
      if (!(avail_s[i] > 0.0)) continue;
      const double mu = __ddiv_rn(row[i], safe);
      row[i] = mu;
      // four rows' loads issued before their stores
      int r = jj + 1;
      for (; r + 3 < w; r += 4) {
        double x[4], pr[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          x[u] = slab[(r + u) * ld + i];
          pr[u] = pcol[r + u];
        }
#pragma unroll
        for (int u = 0; u < 4; ++u)
          slab[(r + u) * ld + i] = __dsub_rn(x[u], __dmul_rn(pr[u], mu));
      }
      for (; r < w; ++r) {
        double* x = slab + r * ld + i;
        *x = __dsub_rn(*x, __dmul_rn(pcol[r], mu));
      }
    }
    __syncthreads();
  }

  if (kSlab)
    for (int r = 0; r < w; ++r)
      for (int i = tid; i < nl; i += kThreads)
        a.mt_out[(size_t)r * m + lane0 + i] = slab[r * ld + i];
  for (int i = tid; i < nl; i += kThreads) a.avail_out[lane0 + i] = avail_s[i];
}

int ceil_div(int a, int b) { return (a + b - 1) / b; }

// what a device offers the kernel, found once per process and device
struct DeviceInfo {
  cudaError_t err;
  int sms;
  size_t smem;       // dynamic shared memory a CTA may take
};
DeviceInfo g_info[kMaxDevices];
std::once_flag g_once[kMaxDevices];

cudaError_t init_device(int dev, DeviceInfo& d) {
  cudaError_t e = cudaDeviceGetAttribute(&d.sms, cudaDevAttrMultiProcessorCount,
                                         dev);
  if (e != cudaSuccess) return e;
  int optin = 0;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev);
  if (e != cudaSuccess) return e;
  d.smem = (size_t)optin - 1024;   // the kernel's static shared memory
  const void* fns[] = {reinterpret_cast<const void*>(&rank1_f64_kernel<true>),
                       reinterpret_cast<const void*>(&rank1_f64_kernel<false>)};
  for (const void* fn : fns) {
    e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(d.smem));
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

const DeviceInfo* device_info(cudaError_t& e) {
  int dev = 0;
  e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return nullptr;
  if (dev < 0 || dev >= kMaxDevices) {
    e = cudaErrorInvalidDevice;
    return nullptr;
  }
  std::call_once(g_once[dev],
                 [&] { g_info[dev].err = init_device(dev, g_info[dev]); });
  e = g_info[dev].err;
  return e == cudaSuccess ? &g_info[dev] : nullptr;
}

}  // namespace

extern "C" {

// doubles of scratch the wrapper allocates for a block of width w (the
// candidate records and columns)
int conflux_rank1_panel_f64_scratch_doubles(int w) {
  return 2 * kMaxGrid * (kHead + w);
}

const char* conflux_rank1_panel_f64_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Launch K1 in double on `stream`. *route receives the route taken (2, the
// grid route, for every shape). Returns 0 or a cudaError_t code (a refused
// launch included); never synchronises.
int conflux_rank1_panel_f64(const double* mt_in, const double* avail_in,
                            double* mt_out, double* avail_out, int* piv,
                            int* ok, double* scratch, int w, int m,
                            int forced, int j0, void* stream, int* route) {
  if (w < 1 || m < 1 || m > 65536) return cudaErrorInvalidValue;
  cudaError_t e;
  const DeviceInfo* d = device_info(e);
  if (d == nullptr) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  *route = kRouteGrid;
  // lanes a CTA aims to own: kLanesPerCta, fewer where the slab of that
  // many would not fit in shared memory (double slabs are twice as wide)
  int target = kLanesPerCta;
  while (target > 32 && smem_bytes(w, target, true) > d->smem) target -= 32;
  // at most one CTA per SM, so the grid is always co-resident
  const int g0 = std::min(std::min(d->sms, kMaxGrid), ceil_div(m, target));
  const int L = ceil_div(m, g0);
  const int G = ceil_div(m, L);
  size_t smem = smem_bytes(w, L, true);
  const bool slab = smem <= d->smem;
  void* fn;
  if (slab) {
    fn = reinterpret_cast<void*>(&rank1_f64_kernel<true>);
  } else {
    fn = reinterpret_cast<void*>(&rank1_f64_kernel<false>);
    smem = smem_bytes(w, L, false);
    if (smem > d->smem) return cudaErrorInvalidValue;
  }
  Args args{mt_in, avail_in, mt_out, avail_out, piv, ok,
            scratch, scratch + 2 * kMaxGrid * kHead, w, m, L, forced, j0};
  void* params[] = {&args};
  e = cudaLaunchCooperativeKernel(fn, dim3(G), dim3(kThreads), params, smem, s);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // extern "C"
