// The panel's pivot-triangle solve, by hand for Hopper (sm_90a).
//
// X = B L^{-T} for B [r, n] and L the unit lower triangle of the pivot
// rows' merged factors: the U12 of ops/panel._lu_select_loop_t's block and
// group updates (each row x of X solves x L^T = b). L's strict lower part
// is read in place from LT = L^T, row-major [n, n]: the factored block's
// pivot lanes as the panel gathers them (lu column-major). LT's diagonal
// and lower part, L's diagonal and upper part, are never read.
//
// Replaces no TPU kernel. The JAX package solves these triangles with
// 32-wide explicit inverses and matrix products
// (conflux_tpu/ops/tri.py: _inv_lower_rec, _solve_right_upper_blocked),
// work for the TPU's matrix unit; run eagerly on the card those chains are
// ~80 launches of 32-128 wide products and elementwise ops per solve, and
// the host issuing them set the panel's pace. The plain version,
// ops/panel._pivot_solve_plain, keeps those chains.
//
// What bounds it on the H100: latency. Each row's substitution is a chain
// of n dependent steps (x_j needs x_0..x_{j-1}); the work, r n^2 / 2
// multiply-adds (4.0 us at the fp32 peak at [1024, 512]), and the bytes of
// B, LT and X (5 MB, 1.5 us) are small. A CTA owns kRows rows of B; each
// warp owns 32-column chunks (one in float32, two in float64, whose
// registers do not fit 16 warps on an SM), a lane one column, and solves
// them left-looking with no barrier: it subtracts each earlier chunk as
// soon as that chunk's owner has published it in shared memory (a flag
// per chunk), loading the next chunk's multipliers from the L2 meanwhile
// (coalesced rows of LT, lane = column), then solves its own 32 x 32
// diagonal block, one row per lane, right-looking and in registers, and
// publishes the chunk. The chain of chunks is the kernel's critical path:
// one subtract and one diagonal solve a chunk, while the warps of later
// chunks work through the earlier ones. IEEE fp32 or f64 fused
// multiply-adds, no tensor cores: every product here is one row against
// one chunk.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kChunk = 32;       // columns per chunk: a warp's lanes
constexpr int kMaxN = 512;
constexpr int kMaxChunks = kMaxN / kChunk;
constexpr int kRows = 8;         // rows of B per CTA
static_assert(kRows % 4 == 0, "x is read in 16-byte loads");

// Warps per CTA at most: a chunk each in float32, two chunks each in
// float64, whose registers do not fit 16 warps on an SM.
template <typename T>
constexpr int max_warps() {
  return sizeof(T) == 4 ? kMaxChunks : kMaxChunks / 2;
}

__device__ __forceinline__ float fmadd(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}

__device__ __forceinline__ double fmadd(double a, double b, double c) {
  return __fma_rn(a, b, c);
}

// l[k] = L[j][c0 + k] = LT[c0 + k][j] for k < kmax, else 0 (never read).
template <typename T>
__device__ __forceinline__ void load_chunk(T (&l)[kChunk],
                                           const T* __restrict__ LT, int n,
                                           int c0, int j, int kmax) {
#pragma unroll
  for (int k = 0; k < kChunk; ++k)
    l[k] = k < kmax ? __ldg(LT + static_cast<size_t>(c0 + k) * n + j)
                    : T(0);
}

// x = xs[0..kRows): one k of a solved chunk (k-major in shared memory),
// the same for every lane, in 16-byte loads.
__device__ __forceinline__ void load_x(float (&x)[kRows], const float* xs) {
#pragma unroll
  for (int q = 0; q < kRows / 4; ++q) {
    const float4 v = reinterpret_cast<const float4*>(xs)[q];
    x[4 * q] = v.x;
    x[4 * q + 1] = v.y;
    x[4 * q + 2] = v.z;
    x[4 * q + 3] = v.w;
  }
}

__device__ __forceinline__ void load_x(double (&x)[kRows],
                                       const double* xs) {
#pragma unroll
  for (int q = 0; q < kRows / 2; ++q) {
    const double2 v = reinterpret_cast<const double2*>(xs)[q];
    x[2 * q] = v.x;
    x[2 * q + 1] = v.y;
  }
}

// acc[i] -= sum_k l[k] xs[k kRows + i]: a solved chunk subtracted from
// this lane's column, k in order.
template <typename T>
__device__ __forceinline__ void subtract_chunk(T (&acc)[kRows],
                                               const T (&l)[kChunk],
                                               const T* xs) {
#pragma unroll
  for (int k = 0; k < kChunk; ++k) {
    T x[kRows];
    load_x(x, xs + k * kRows);
#pragma unroll
    for (int i = 0; i < kRows; ++i) acc[i] = fmadd(-l[k], x[i], acc[i]);
  }
}

// Forward substitution through a chunk's unit diagonal block, one row per
// lane (lanes below kRows): the rows' right-hand sides k-major in x,
// solved in place; diag[k][lane] = L[32 J + lane][32 J + k] for k < lane
// (0 elsewhere). Right-looking, so the updates of one step are independent
// of one another, and the lanes never exchange a value.
template <typename T>
__device__ __forceinline__ void solve_rows(T* x, const T* diag, int lane) {
  if (lane < kRows) {
    T v[kChunk];
#pragma unroll
    for (int k = 0; k < kChunk; ++k) v[k] = x[k * kRows + lane];
#pragma unroll
    for (int k = 0; k + 1 < kChunk; ++k) {
#pragma unroll
      for (int j = k + 1; j < kChunk; ++j)
        v[j] = fmadd(-diag[k * kChunk + j], v[k], v[j]);
    }
#pragma unroll
    for (int k = 0; k < kChunk; ++k) x[k * kRows + lane] = v[k];
  }
}

// Solve the chunk whose values this warp holds in acc (lane = column): the
// values go to x (k-major, where the chunk is then published from), are
// solved there row by row, and come back into acc.
template <typename T>
__device__ __forceinline__ void solve_chunk(T (&acc)[kRows], T* x,
                                            const T* diag, int lane) {
#pragma unroll
  for (int i = 0; i < kRows; ++i) x[lane * kRows + i] = acc[i];
  __syncwarp();
  solve_rows(x, diag, lane);
  __syncwarp();
  load_x(acc, x + lane * kRows);
}

// Wait until chunk c is published, then see what its owner wrote.
__device__ __forceinline__ void wait_for(const int* ready, int c) {
  while (*reinterpret_cast<const volatile int*>(ready + c) == 0)
    __nanosleep(32);
  __threadfence_block();
}

template <typename T, int W>
__global__ void __launch_bounds__(32 * W)
panel_trsm_kernel(const T* __restrict__ B, const T* __restrict__ LT,
                  T* __restrict__ X, int r, int n) {
  // shared memory: every chunk's solved values, k-major, then each warp's
  // diagonal block (diag[k][lane] = L[j][32 J + k], k < lane); ready[J]
  // turns 1 once chunk J's values are there
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int ready[kMaxChunks];
  constexpr int kX = kChunk * kRows;
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nch = (n + kChunk - 1) / kChunk;
  T* xs = reinterpret_cast<T*>(smem);
  T* diag = xs + nch * kX + warp * kChunk * kChunk;
  const long long row0 = static_cast<long long>(blockIdx.x) * kRows;
  const int rows = static_cast<int>(
      r - row0 < kRows ? r - row0 : static_cast<long long>(kRows));
  if (threadIdx.x < kMaxChunks) ready[threadIdx.x] = 0;
  __syncthreads();

  for (int J = warp; J < nch; J += warps) {
    const int j = J * kChunk + lane;     // lanes past n hold zeros
    T acc[kRows], l[kChunk], ahead[kChunk];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
      acc[i] = j < n && i < rows ? B[(row0 + i) * n + j] : T(0);
    load_chunk(ahead, LT, n, J * kChunk, j, j < n ? lane : 0);
#pragma unroll
    for (int k = 0; k < kChunk; ++k) diag[k * kChunk + lane] = ahead[k];
    if (J > 0) load_chunk(l, LT, n, 0, j, j < n ? kChunk : 0);
    for (int c = 0; c < J; ++c) {
      if (c + 1 < J)
        load_chunk(ahead, LT, n, (c + 1) * kChunk, j, j < n ? kChunk : 0);
      wait_for(ready, c);
      subtract_chunk(acc, l, xs + c * kX);
#pragma unroll
      for (int k = 0; k < kChunk; ++k) l[k] = ahead[k];
    }
    solve_chunk(acc, xs + J * kX, diag, lane);
    __threadfence_block();
    __syncwarp();
    if (lane == 0) *reinterpret_cast<volatile int*>(ready + J) = 1;
    if (j < n) {
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        if (i < rows) X[(row0 + i) * n + j] = acc[i];
    }
  }
}

template <typename T>
int launch(const void* B, const void* LT, void* X, int r, int n,
           cudaStream_t stream) {
  constexpr int W = max_warps<T>();
  const int nch = (n + kChunk - 1) / kChunk;
  const int warps = nch < W ? nch : W;
  const long long grid = (static_cast<long long>(r) + kRows - 1) / kRows;
  const int smem = static_cast<int>(
      (nch * kChunk * kRows + warps * kChunk * kChunk) * sizeof(T));
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        panel_trsm_kernel<T, W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  panel_trsm_kernel<T, W><<<static_cast<unsigned>(grid), warps * 32, smem,
                            stream>>>(static_cast<const T*>(B),
                                      static_cast<const T*>(LT),
                                      static_cast<T*>(X), r, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* conflux_panel_trsm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// X = B L^{-T} on `stream`: B and X [r, n] row-major, LT = L^T [n, n]
// row-major (L unit lower; only LT's strict upper part is read); float32,
// or float64 when f64 != 0. Returns 0 or a cudaError_t code
// (cudaErrorInvalidValue for r < 1 or n outside 1..kMaxN); never
// synchronises.
int conflux_panel_trsm(const void* B, const void* LT, void* X, int r, int n,
                       int f64, void* stream) {
  if (r < 1 || n < 1 || n > kMaxN)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  return f64 ? launch<double>(B, LT, X, r, n, s)
             : launch<float>(B, LT, X, r, n, s);
}

}  // extern "C"
