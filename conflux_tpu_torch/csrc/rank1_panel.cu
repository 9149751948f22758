// K1: masked-argmax partial-pivoting rank-1 elimination of a transposed
// panel block, by hand for Hopper (sm_90a).
//
// Replaces the TPU kernel conflux_tpu/ops/pallas_panel.py:_rank1_kernel
// (wrapper rank1_block_pallas_t). Same inputs and outputs:
//   Mt [w, m] f32 (panel columns as rows, matrix rows as lanes),
//   avail [1, m] f32 (> 0 = selectable)
//   -> Mt' [w, m], avail' [1, m], piv [w] i32, ok [w] i32.
// For each column jj in order: pick the available lane p of largest |Mt[jj]|
// (lowest lane on ties, NaN ranks highest, as jnp.argmax), or p = j0 + jj
// in forced mode; store col / pivot (a true division; a zero pivot divides
// by 1) as the multipliers of the other available lanes in row jj; update
// rows jj+1..w-1 of those lanes by the rank-1 product; retire lane p.
//
// The TPU kernel's two-level structure (32-wide micro-panels plus a
// deferred one-hot GEMM update per boundary) exists to move VPU work onto
// the TPU's matrix unit. It is not carried over: this is the straight
// right-looking elimination, mathematically the same. Once a lane is
// retired its multiplier is 0, so pivot lanes keep the merged-factor values
// they held when selected; that is exactly what forced and finish modes ask
// for, so all three modes run the same code. (In unforced mode the TPU
// kernel leaves pivot lanes of later rows stale and no caller reads them.)
// Each update is the rank-1 step's own formula, x - pivcol * mult, with the
// product rounded before the subtraction (no fused multiply-add), and the
// multiplier is a true division.
//
// What bounds it on the H100: the block is 16 MiB at the main path's
// [128, 32768], and one CTA has at most 227 KB of shared memory, while each
// column's pivot search spans every lane. The design is one persistent
// cooperative launch: each CTA owns a contiguous slice of lanes and keeps
// its [w, lanes] slab in shared memory for the whole call (about 129 KB at
// m = 32768 over 128 CTAs; blocks too wide for that work on the output in
// global memory, which the 50 MB L2 holds). Per column, each CTA publishes
// its local candidate together with that lane's column values, one grid
// barrier makes them visible, and every CTA reduces the candidates in the
// same deterministic order, so no second barrier is needed to learn the
// pivot column. The cost is about w grid barriers per call plus one
// read-modify-write of the block per column, all from shared memory; at
// small m the barriers dominate. No tensor cores: each column's update is
// rank-1 and depends on the previous column's pivot.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <climits>
#include <cmath>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLanesPerCta = 256;            // lanes a CTA aims to own
constexpr int kMaxGrid = 1024;               // bound of the scratch layout
constexpr int kHead = 4;                     // score, lane, avail[lane], pad
constexpr size_t kSmemLimit = 200 * 1024;    // slab variant up to this size

struct Args {
  const float* mt_in;
  const float* avail_in;
  float* mt_out;
  float* avail_out;
  int* piv;
  int* ok;
  float* head;   // [2][grid][kHead] candidate records, double-buffered
  float* cols;   // [2][grid][w] each candidate lane's column values
  int w;
  int m;
  int lanes;     // lanes per CTA
  int forced;
  int j0;
};

// argmax order: larger score wins, NaN beats any number, lower lane on ties
__device__ __forceinline__ bool better(float a, int ia, float b, int ib) {
  const bool na = isnan(a), nb = isnan(b);
  if (na || nb) return na && (!nb || ia < ib);
  return a > b || (a == b && ia < ib);
}

__device__ __forceinline__ void warp_best(float& s, int& i, int& c) {
  for (int off = 16; off > 0; off >>= 1) {
    const float os = __shfl_down_sync(0xffffffffu, s, off);
    const int oi = __shfl_down_sync(0xffffffffu, i, off);
    const int oc = __shfl_down_sync(0xffffffffu, c, off);
    if (better(os, oi, s, i)) {
      s = os;
      i = oi;
      c = oc;
    }
  }
}

template <bool kSlab>
__global__ void __launch_bounds__(kThreads, 1) rank1_panel_kernel(Args a) {
  extern __shared__ float smem[];
  __shared__ float red_s[kWarps];
  __shared__ int red_i[kWarps];
  __shared__ int win_cta;

  const int w = a.w, m = a.m, L = a.lanes;
  const int G = gridDim.x;
  const int tid = threadIdx.x;
  const int lane0 = blockIdx.x * L;
  const int nl = min(L, m - lane0);  // >= 1: the host sizes the grid so

  // the slab holds this CTA's [w, nl] lanes: shared memory with row stride
  // L, or the output block itself with row stride m
  float* slab;
  size_t ld;
  float* avail_s;
  if (kSlab) {
    slab = smem;
    ld = L;
    avail_s = smem + (size_t)w * L;
  } else {
    slab = a.mt_out + lane0;
    ld = m;
    avail_s = smem;
  }
  float* pcol = avail_s + L;  // [w] pivot lane's column values

  for (int r = 0; r < w; ++r)
    for (int i = tid; i < nl; i += kThreads)
      slab[r * ld + i] = a.mt_in[(size_t)r * m + lane0 + i];
  for (int i = tid; i < nl; i += kThreads) avail_s[i] = a.avail_in[lane0 + i];
  __syncthreads();

  cg::grid_group grid = cg::this_grid();

  for (int jj = 0; jj < w; ++jj) {
    float* row = slab + jj * ld;

    // 1. this CTA's candidate: masked |x| argmax over its lanes
    const int fp = a.j0 + jj;
    float best = -INFINITY;
    int bi = INT_MAX;
    for (int i = tid; i < nl; i += kThreads) {
      const int gi = lane0 + i;
      float s;
      if (a.forced)
        s = gi == fp ? INFINITY : -INFINITY;
      else
        s = avail_s[i] > 0.f ? fabsf(row[i]) : -INFINITY;
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
    if (tid == 0) {
      for (int k = 1; k < kWarps; ++k)
        if (better(red_s[k], red_i[k], red_s[0], red_i[0])) {
          red_s[0] = red_s[k];
          red_i[0] = red_i[k];
        }
    }
    __syncthreads();
    best = red_s[0];
    bi = red_i[0];  // a real lane of this CTA: nl >= 1 and -inf ties go low

    // 2. publish it with its column values (rows jj..w-1), L2 only: the
    // records are rewritten every other column, and L1 is not coherent
    const int buf = jj & 1;
    const int li = bi - lane0;
    float* head = a.head + ((size_t)buf * G + blockIdx.x) * kHead;
    float* cbuf = a.cols + ((size_t)buf * G + blockIdx.x) * w;
    for (int r = jj + tid; r < w; r += kThreads) __stcg(cbuf + r, slab[r * ld + li]);
    if (tid == 0) {
      __stcg(head + 0, best);
      __stcg(head + 1, __int_as_float(bi));
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
      float s = -INFINITY;
      int i = INT_MAX, c = 0;
      for (int k = tid; k < G; k += 32) {
        const float* h = a.head + ((size_t)buf * G + k) * kHead;
        const float ks = __ldcg(h);
        const int ki = __float_as_int(__ldcg(h + 1));
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
    const float* wh = a.head + ((size_t)buf * G + win_cta) * kHead;
    const float* wcol = a.cols + ((size_t)buf * G + win_cta) * w;
    const int p = __float_as_int(__ldcg(wh + 1));
    const float pv = __ldcg(wcol + jj);
    for (int r = jj + 1 + tid; r < w; r += kThreads) pcol[r] = __ldcg(wcol + r);
    if (blockIdx.x == 0 && tid == 0) {
      a.piv[jj] = p;
      a.ok[jj] = __ldcg(wh + 2) > 0.f ? 1 : 0;
    }
    __syncthreads();

    // 5. rank-1 update of this CTA's available, non-pivot lanes
    const float safe = pv == 0.f ? 1.f : pv;
    for (int i = tid; i < nl; i += kThreads) {
      if (lane0 + i == p) {
        avail_s[i] = 0.f;
        continue;
      }
      if (!(avail_s[i] > 0.f)) continue;
      const float mu = __fdiv_rn(row[i], safe);
      row[i] = mu;
      for (int r = jj + 1; r < w; ++r) {
        float* x = slab + r * ld + i;
        *x = __fsub_rn(*x, __fmul_rn(pcol[r], mu));
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

}  // namespace

extern "C" {

// floats of scratch the wrapper allocates for a block of width w
int conflux_rank1_panel_scratch_floats(int w) { return 2 * kMaxGrid * (kHead + w); }

const char* conflux_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Launch K1 on `stream`. Returns 0 or a cudaError_t code (a refused
// launch included); never synchronises.
int conflux_rank1_panel(const float* mt_in, const float* avail_in,
                        float* mt_out, float* avail_out, int* piv, int* ok,
                        float* scratch, int w, int m, int forced, int j0,
                        void* stream) {
  if (w < 1 || m < 1) return cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;

  // at most one CTA per SM, so the grid is always co-resident
  const int g0 = std::min(std::min(sms, kMaxGrid), ceil_div(m, kLanesPerCta));
  const int L = ceil_div(m, g0);
  const int G = ceil_div(m, L);
  size_t smem = ((size_t)w * L + L + w) * sizeof(float);
  const bool slab = smem <= kSmemLimit;
  void* fn;
  if (slab) {
    fn = reinterpret_cast<void*>(&rank1_panel_kernel<true>);
  } else {
    fn = reinterpret_cast<void*>(&rank1_panel_kernel<false>);
    smem = ((size_t)L + w) * sizeof(float);
  }
  e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads, smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;

  Args args{mt_in, avail_in, mt_out, avail_out, piv, ok,
            scratch, scratch + 2 * kMaxGrid * kHead, w, m, L, forced, j0};
  void* params[] = {&args};
  e = cudaLaunchCooperativeKernel(fn, dim3(G), dim3(kThreads), params, smem,
                                  static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // extern "C"
