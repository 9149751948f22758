// The panel's pivot-lane gather and scatter, by hand for Hopper (sm_90a).
//
// ops/panel._lu_select_loop_t keeps its panel transposed, Pt [n, m]: the
// panel's columns are rows of Pt and the matrix rows are its lanes.
// Between K1 blocks each deferred update reads the factored block's pivot
// lanes, out[r, j] = ok[j] ? src[r, piv[j]] : 0 (gather), and, where the
// elimination finishes its pivot lanes, writes their U12 back,
// dst[r, piv[j]] = src[r, j] for every j with ok[j] (scatter).
//
// Replaces no TPU kernel. The JAX package moves these lanes by one-hot
// matrix products over all m lanes, since a TPU kernel cannot index
// lanes; run on the card those are split-K library products with K = m,
// up to 32768, for an output of at most [1536, 512] words.
//
// What bounds them on the H100: latency. A move touches rows x n words
// (at most [1536, 512], 3 MB in float64), a few microseconds at the
// card's bandwidth. One thread moves one word as raw bits (float32 and
// float64 alike), so a moved value is exact. The entries whose ok is set
// name distinct lanes (each is a lane the elimination had not taken
// before), so the scatter's writes never collide and its result is
// deterministic; an entry whose ok is clear moves nothing, whatever lane
// it names. A lane outside [0, m) is never read or written (the gather
// gives 0 there).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 1 << 16;

template <typename W>
__global__ void __launch_bounds__(kThreads)
pivot_lane_gather_kernel(const W* __restrict__ src, long long ld,
                         long long m, const long long* __restrict__ piv,
                         const unsigned char* __restrict__ ok, int n,
                         long long total, W* __restrict__ out) {
  const long long step = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       i < total; i += step) {
    const long long r = i / n;
    const int j = static_cast<int>(i - r * n);
    const long long p = piv[j];
    out[i] = ok[j] && p >= 0 && p < m ? src[r * ld + p] : W(0);
  }
}

template <typename W>
__global__ void __launch_bounds__(kThreads)
pivot_lane_index_scatter_kernel(W* __restrict__ dst, long long ld,
                                long long m,
                                const long long* __restrict__ piv,
                                const unsigned char* __restrict__ ok, int n,
                                long long total, const W* __restrict__ src) {
  const long long step = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       i < total; i += step) {
    const long long r = i / n;
    const int j = static_cast<int>(i - r * n);
    const long long p = piv[j];
    if (ok[j] && p >= 0 && p < m) dst[r * ld + p] = src[i];
  }
}

template <typename W>
int launch(int scatter, void* lanes, long long ld, long long m, int rows,
           const long long* piv, const unsigned char* ok, int n, void* dense,
           cudaStream_t stream) {
  const long long total = static_cast<long long>(rows) * n;
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  const unsigned grid = static_cast<unsigned>(blocks);
  if (scatter)
    pivot_lane_index_scatter_kernel<W><<<grid, kThreads, 0, stream>>>(
        static_cast<W*>(lanes), ld, m, piv, ok, n, total,
        static_cast<const W*>(dense));
  else
    pivot_lane_gather_kernel<W><<<grid, kThreads, 0, stream>>>(
        static_cast<const W*>(lanes), ld, m, piv, ok, n, total,
        static_cast<W*>(dense));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* conflux_lane_move_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// One pivot-lane move on `stream`. `lanes` is the strided side, rows x m
// words with row stride `ld` words; `dense` the contiguous [rows, n] side;
// piv [n] int64 and ok [n] bytes (0 or 1). scatter == 0: dense[r, j] =
// ok[j] ? lanes[r, piv[j]] : 0. scatter != 0: lanes[r, piv[j]] = dense[r,
// j] where ok[j]. Words of `esize` bytes, 4 or 8. Returns 0 or a
// cudaError_t code (cudaErrorInvalidValue for a bad size); never
// synchronises.
int conflux_lane_move(int scatter, void* lanes, long long ld, long long m,
                      int rows, const void* piv, const void* ok, int n,
                      void* dense, int esize, void* stream) {
  if (rows < 0 || n < 0 || m < 0 || ld < m || (esize != 4 && esize != 8))
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0 || n == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  auto p = static_cast<const long long*>(piv);
  auto o = static_cast<const unsigned char*>(ok);
  return esize == 8
             ? launch<unsigned long long>(scatter, lanes, ld, m, rows, p, o,
                                          n, dense, s)
             : launch<unsigned int>(scatter, lanes, ld, m, rows, p, o, n,
                                    dense, s);
}

}  // extern "C"
