// The diagonal blocks of crout's winners' solve, by hand for Hopper
// (sm_90a).
//
// Each crout step finishes the winners' factor row by X = L^{-1} B, with
// L the unit lower triangle of the pivot rows' merged factors lu [w, w]
// (w = 1536 at the cells) and B the winners' updated trailing values
// [w, c] (c up to 31232). ops/tri.solve_lower_rows takes L's block rows in
// turn: one library product subtracts the solved rows above, then this
// kernel solves the block's own triangle, X_ii = L_ii^{-1} B_i, with
// L_ii [b, b], b <= 512, and B_i, X_i [b, c] row-major with their own
// leading dimensions (X_i a slice of the factor, written in place). L's
// strict lower part is read in place through two strides (lu as the step
// leaves it, row- or column-major); its diagonal and upper part are never
// read.
//
// Replaces no TPU kernel. The JAX package solves these rows with 32-wide
// explicit inverses and matrix products (conflux_tpu/ops/tri.py:
// _solve_unit_lower_blocked), work for the TPU's matrix unit; run eagerly
// on the card that chain is ~210 kernels and copies a solve, whose
// launching set the pace of the host-bound cells. The plain version,
// ops/tri._diag_solve_plain, substitutes row by row.
//
// What bounds it on the H100: meant to be the fp32 (fp64) FMA rate; in
// crout at N = 32768 it reaches ~11 TFLOP/s of fp32, with two CTAs of
// four warps an SM (110 KB of shared memory each at b = 384) to hide a
// barrier a 32 x 32 tile and the diagonal's 31-step chain. The columns of B
// are independent, so a CTA owns a slab of kCols columns and keeps the
// block's solved slab X[:b, slab] in shared memory. It walks the block in
// 32-row chunks, left-looking. A thread holds a 4-row, TC-column register
// tile of the chunk, loaded from B; it subtracts the earlier chunks'
// contributions (the rows of L stream through shared memory one 32 x 32
// tile at a time, the next tile's loads in flight under the current one's
// products), then the chunk's 32 x 32 unit diagonal triangle is solved in
// registers by exact forward substitution, right-looking: at step k the
// eight threads that hold a column's 32 rows take x_k from its owner by a
// shuffle and each subtracts L[j][k] x_k from its rows j (0 for j <= k).
// The tile goes to the slab and to X. b^2 c / 2 multiply-adds a block,
// IEEE fp32 or f64 fused multiply-adds in a fixed order: no tensor cores,
// no atomics, the same bits run to run.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kChunk = 32;         // rows a chunk; the diagonal triangle
constexpr int kMaxRows = 512;
constexpr int kThreads = 128;
constexpr int kTileRows = 4;       // rows of a thread's register tile
constexpr int kTx = 16;            // threads across a slab's columns
constexpr int kLd = kChunk + 4;    // L tile row pitch (16-byte rows)
static_assert(kThreads == kTx * (kChunk / kTileRows), "thread layout");
static_assert(kChunk * kChunk % kThreads == 0, "L tile loads");

__device__ __forceinline__ float fmadd(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}

__device__ __forceinline__ double fmadd(double a, double b, double c) {
  return __fma_rn(a, b, c);
}

// v[0..N) = p[0..N) from shared memory, in 16- or 8-byte loads (p aligned
// to N elements).
template <typename T, int N>
__device__ __forceinline__ void load_vec(T (&v)[N], const T* p) {
  if constexpr (sizeof(T) * N % 16 == 0) {
#pragma unroll
    for (int q = 0; q < N; q += 16 / sizeof(T)) {
      const float4 u = *reinterpret_cast<const float4*>(p + q);
      const T* s = reinterpret_cast<const T*>(&u);
#pragma unroll
      for (int e = 0; e < 16 / static_cast<int>(sizeof(T)); ++e)
        v[q + e] = s[e];
    }
  } else if constexpr (sizeof(T) * N == 8) {
    const float2 u = *reinterpret_cast<const float2*>(p);
    const T* s = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int e = 0; e < N; ++e) v[e] = s[e];
  } else {
#pragma unroll
    for (int e = 0; e < N; ++e) v[e] = p[e];
  }
}

// v[q] = p[q] for q < n, else 0: a row of a thread's tile from global
// memory, in one 16-byte load where vec (p 16-byte aligned, n == N).
template <typename T, int N>
__device__ __forceinline__ void read_row(T (&v)[N], const T* __restrict__ p,
                                         int n, bool vec) {
  if constexpr (sizeof(T) * N == 16) {
    if (vec) {
      const float4 u = __ldg(reinterpret_cast<const float4*>(p));
      const T* w = reinterpret_cast<const T*>(&u);
#pragma unroll
      for (int q = 0; q < N; ++q) v[q] = w[q];
      return;
    }
  }
#pragma unroll
  for (int q = 0; q < N; ++q) v[q] = q < n ? p[q] : T(0);
}

// p[q] = v[q] for q < n, in one 16-byte store where vec.
template <typename T, int N>
__device__ __forceinline__ void write_row(T* __restrict__ p, const T (&v)[N],
                                          int n, bool vec) {
  if constexpr (sizeof(T) * N == 16) {
    if (vec) {
      float4 u;
      T* w = reinterpret_cast<T*>(&u);
#pragma unroll
      for (int q = 0; q < N; ++q) w[q] = v[q];
      *reinterpret_cast<float4*>(p) = u;
      return;
    }
  }
#pragma unroll
  for (int q = 0; q < N; ++q)
    if (q < n) p[q] = v[q];
}

// 16-byte accesses to rows of M at p + r ld + c0, c0 a multiple of TC.
template <typename T, int TC>
__device__ __forceinline__ bool rows_aligned(const T* p, long long ld) {
  return sizeof(T) * TC == 16 &&
         (reinterpret_cast<uintptr_t>(p) | ld * sizeof(T)) % 16 == 0;
}

// The L tile L[r0 + r][k0 + k], r, k < kChunk, that this thread loads:
// kChunk^2 / kThreads entries, consecutive threads on L's unit stride.
// Only the strict lower part of the block is read: entries with r0 + r
// at or past b, or k0 + k at or past r0 + r, are 0.
template <typename T>
__device__ __forceinline__ void fetch_tile(
    T (&t)[kChunk * kChunk / kThreads], const T* __restrict__ L,
    long long lsr, long long lsc, int b, int r0, int k0) {
  const bool row_major = lsc == 1;
#pragma unroll
  for (int q = 0; q < kChunk * kChunk / kThreads; ++q) {
    const int e = threadIdx.x + q * kThreads;
    const int r = row_major ? e / kChunk : e % kChunk;
    const int k = row_major ? e % kChunk : e / kChunk;
    t[q] = r0 + r < b && k0 + k < r0 + r
               ? __ldg(L + (r0 + r) * lsr + (k0 + k) * lsc)
               : T(0);
  }
}

// The fetched entries into a tile kept k-major, dst[k * kLd + r].
template <typename T>
__device__ __forceinline__ void stash_tile(
    const T (&t)[kChunk * kChunk / kThreads], T* dst, long long lsc) {
  const bool row_major = lsc == 1;
#pragma unroll
  for (int q = 0; q < kChunk * kChunk / kThreads; ++q) {
    const int e = threadIdx.x + q * kThreads;
    const int r = row_major ? e / kChunk : e % kChunk;
    const int k = row_major ? e % kChunk : e / kChunk;
    dst[k * kLd + r] = t[q];
  }
}

// The eight lanes of a column group hold its 32 rows, 4 a lane.
constexpr int kRowLanes = kChunk / kTileRows;
static_assert(32 % kRowLanes == 0, "a column group within a warp");

template <typename T, int TC>
__global__ void __launch_bounds__(kThreads)
lower_solve_kernel(const T* __restrict__ L, long long lsr, long long lsc,
                   const T* __restrict__ B, long long ldb,
                   T* __restrict__ X, long long ldx, int b, int c) {
  constexpr int kCols = kTx * TC;                 // the CTA's slab
  constexpr int kFetch = kChunk * kChunk / kThreads;
  // shared memory: the slab xs[row][col] of every chunk so far, then two
  // off-diagonal L tiles and the diagonal one, each k-major
  extern __shared__ __align__(16) unsigned char smem[];
  const int nch = (b + kChunk - 1) / kChunk;
  T* xs = reinterpret_cast<T*>(smem);
  T* lt = xs + nch * kChunk * kCols;
  T* ld = lt + 2 * kChunk * kLd;
  // rows ty * 4 .. + 4 of a chunk, columns tx * TC .. + TC of the slab
  const int ty = threadIdx.x % kRowLanes, tx = threadIdx.x / kRowLanes;
  const long long c0 = static_cast<long long>(blockIdx.x) * kCols + tx * TC;
  // the thread's columns in range, and whether its rows of B and X take
  // 16-byte accesses
  const int cols = static_cast<int>(c - c0 < TC ? (c > c0 ? c - c0 : 0)
                                                : TC);
  const bool vec_b = cols == TC && rows_aligned<T, TC>(B, ldb);
  const bool vec_x = cols == TC && rows_aligned<T, TC>(X, ldx);

  for (int s = 0; s < nch; ++s) {
    const int r0 = s * kChunk;
    const int row = r0 + ty * kTileRows;
    T acc[kTileRows][TC];
#pragma unroll
    for (int i = 0; i < kTileRows; ++i)
      read_row(acc[i], B + (row + i) * ldb + c0, row + i < b ? cols : 0,
               vec_b && row + i < b);
    T next[kFetch];
    if (s > 0) fetch_tile(next, L, lsr, lsc, b, r0, 0);
    // the earlier chunks' contributions, k in order
    for (int kt = 0; kt < s; ++kt) {
      T* tile = lt + (kt & 1) * kChunk * kLd;
      stash_tile(next, tile, lsc);
      __syncthreads();
      if (kt + 1 < s)
        fetch_tile(next, L, lsr, lsc, b, r0, (kt + 1) * kChunk);
      const T* xk = xs + kt * kChunk * kCols + tx * TC;
#pragma unroll 8
      for (int k = 0; k < kChunk; ++k) {
        T a[kTileRows], x[TC];
        load_vec(a, tile + k * kLd + ty * kTileRows);
        load_vec(x, xk + k * kCols);
#pragma unroll
        for (int i = 0; i < kTileRows; ++i)
#pragma unroll
          for (int q = 0; q < TC; ++q)
            acc[i][q] = fmadd(-a[i], x[q], acc[i][q]);
      }
    }
    // the diagonal triangle, ld[k][j] = L[r0 + j][r0 + k] for j > k, else
    // 0
    T diag[kFetch];
    fetch_tile(diag, L, lsr, lsc, b, r0, r0);
    stash_tile(diag, ld, lsc);
    __syncthreads();
#pragma unroll
    for (int k = 0; k + 1 < kChunk; ++k) {
      T a[kTileRows], x[TC];
      load_vec(a, ld + k * kLd + ty * kTileRows);
#pragma unroll
      for (int q = 0; q < TC; ++q)
        x[q] = __shfl_sync(0xffffffffu, acc[k % kTileRows][q],
                           k / kTileRows, kRowLanes);
#pragma unroll
      for (int i = 0; i < kTileRows; ++i)
#pragma unroll
        for (int q = 0; q < TC; ++q)
          acc[i][q] = fmadd(-a[i], x[q], acc[i][q]);
    }
#pragma unroll
    for (int i = 0; i < kTileRows; ++i) {
#pragma unroll
      for (int q = 0; q < TC; ++q)
        xs[(row + i) * kCols + tx * TC + q] = acc[i][q];
      if (row + i < b)
        write_row(X + (row + i) * ldx + c0, acc[i], cols, vec_x);
    }
  }
}

// Shared memory of one CTA: the slab, two L tiles, the diagonal tile.
template <typename T, int TC>
int smem_bytes(int b) {
  const int nch = (b + kChunk - 1) / kChunk;
  return static_cast<int>((nch * kChunk * kTx * TC + 3 * kChunk * kLd) *
                          sizeof(T));
}

template <typename T, int TC>
int launch(const void* L, long long lsr, long long lsc, const void* B,
           long long ldb, void* X, long long ldx, int b, int c,
           cudaStream_t stream) {
  constexpr int kCols = kTx * TC;
  const int smem = smem_bytes<T, TC>(b);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        lower_solve_kernel<T, TC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const unsigned grid = static_cast<unsigned>((c + kCols - 1) / kCols);
  lower_solve_kernel<T, TC><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(L), lsr, lsc, static_cast<const T*>(B), ldb,
      static_cast<T*>(X), ldx, b, c);
  return static_cast<int>(cudaGetLastError());
}

// The widest slab whose shared memory leaves room for two CTAs an SM
// (228 KB, 1 KB of it reserved for each CTA): 64 columns in float32 up
// to b = 384, else 32; in float64 32 up to b = 256, else 16.
template <typename T>
int launch_widest(const void* L, long long lsr, long long lsc, const void* B,
                  long long ldb, void* X, long long ldx, int b, int c,
                  cudaStream_t stream) {
  constexpr int kTwoCtas = 113 * 1024;
  if constexpr (sizeof(T) == 4) {
    if (smem_bytes<T, 4>(b) <= kTwoCtas)
      return launch<T, 4>(L, lsr, lsc, B, ldb, X, ldx, b, c, stream);
  }
  if (smem_bytes<T, 2>(b) <= kTwoCtas)
    return launch<T, 2>(L, lsr, lsc, B, ldb, X, ldx, b, c, stream);
  return launch<T, 1>(L, lsr, lsc, B, ldb, X, ldx, b, c, stream);
}

}  // namespace

extern "C" {

const char* conflux_lower_solve_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// X = L^{-1} B on `stream` for L unit lower [b, b], entry (r, k) at
// L[r lsr + k lsc] (only k < r is read), B and X [b, c] row-major with
// leading dimensions ldb and ldx (distinct memory); float32, or float64
// when f64 != 0. Returns 0 or a cudaError_t code (cudaErrorInvalidValue
// for b outside 1..kMaxRows, c < 1, or a leading dimension under c);
// never synchronises.
int conflux_lower_solve(const void* L, long long lsr, long long lsc,
                        const void* B, long long ldb, void* X,
                        long long ldx, int b, int c, int f64, void* stream) {
  if (b < 1 || b > kMaxRows || c < 1 || ldb < c || ldx < c)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  return f64 ? launch_widest<double>(L, lsr, lsc, B, ldb, X, ldx, b, c, s)
             : launch_widest<float>(L, lsr, lsc, B, ldb, X, ldx, b, c, s);
}

}  // extern "C"
