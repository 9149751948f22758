// K5 and K6: whole-row scatter and gather, by hand for Hopper (sm_90a).
//
// K5 replaces conflux_tpu/ops/pallas_scatter.py:scatter_rows (kernel
// _scatter_kernel): R[slots[i], :] = src[i, :], in place in R.
// K6 replaces pallas_scatter.py:gather_rows (kernel _gather_kernel):
// out[i, :] = R[idx[i], :], into a fresh tensor.
// Rows are moved whole, as raw bytes (float32 or bfloat16 alike), so the
// result is bit-exact. Slots are unique and in [0, m), the caller's
// contract: there is no masking, and a pair that should do nothing is a
// self-write (src[i] == R[slots[i]]). An index outside [0, m) is skipped,
// so a bad index cannot fault, but its row is not written.
//
// What bounds them on the H100: bytes. Each moves 2 x rows x row_bytes
// (one read, one write) and computes nothing, so the least time is that
// over 3.35 TB/s: 0.13 ms for crout's [1536, 32768] f32 push-up. The TPU
// kernels issue one DMA descriptor per whole row, with the row ids
// scalar-prefetched. Here a block of 256 threads copies a 16 KB chunk of
// one row (4 words per thread, all loads issued before the stores), in
// 16-byte words where both row starts and strides are 16-byte aligned
// (4-byte or 2-byte words otherwise), so neighbouring threads touch
// neighbouring addresses; the grid is (rows, chunks per row), each block
// reads its own row index, and a [1536, 32768] f32 move is 12 288 blocks,
// enough in flight on 132 SMs to cover the latency of device memory. Any
// row stride: the split compaction gathers from a column slice of T.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;                    // words per thread per block
constexpr int kChunkWords = kThreads * kUnroll;

template <typename W, bool kScatter>
__device__ __forceinline__ void move_row(const char* src, long long lds,
                                         char* dst, long long ldd,
                                         const long long* idx, long long m,
                                         int words) {
  const long long i = blockIdx.x;
  const long long r = idx[i];
  if (r < 0 || r >= m) return;
  const W* s = reinterpret_cast<const W*>(src + (kScatter ? i : r) * lds);
  W* d = reinterpret_cast<W*>(dst + (kScatter ? r : i) * ldd);
  const int base = blockIdx.y * kChunkWords + threadIdx.x;
  W v[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int j = base + u * kThreads;
    if (j < words) v[u] = s[j];
  }
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int j = base + u * kThreads;
    if (j < words) d[j] = v[u];
  }
}

// out[i] = R[idx[i]]: src is R, dst is out
template <typename W>
__global__ void __launch_bounds__(kThreads) gather_rows_kernel(
    const char* src, long long lds, char* dst, long long ldd,
    const long long* idx, long long m, int words) {
  move_row<W, false>(src, lds, dst, ldd, idx, m, words);
}

// R[slots[i]] = src[i]: dst is R
template <typename W>
__global__ void __launch_bounds__(kThreads) scatter_rows_kernel(
    const char* src, long long lds, char* dst, long long ldd,
    const long long* idx, long long m, int words) {
  move_row<W, true>(src, lds, dst, ldd, idx, m, words);
}

template <typename W>
cudaError_t launch(int scatter, const void* src, long long lds, void* dst,
                   long long ldd, const long long* idx, int rows,
                   long long m, long long row_bytes, cudaStream_t stream) {
  const long long words = row_bytes / sizeof(W);
  const long long chunks = (words + kChunkWords - 1) / kChunkWords;
  if (words > 0x7fffffffLL || chunks > 65535) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(rows), static_cast<unsigned>(chunks));
  const char* s = static_cast<const char*>(src);
  char* d = static_cast<char*>(dst);
  if (scatter)
    scatter_rows_kernel<W><<<grid, kThreads, 0, stream>>>(
        s, lds, d, ldd, idx, m, static_cast<int>(words));
  else
    gather_rows_kernel<W><<<grid, kThreads, 0, stream>>>(
        s, lds, d, ldd, idx, m, static_cast<int>(words));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* conflux_row_move_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Move `rows` whole rows of row_bytes bytes on `stream`. scatter == 0 (K6):
// dst row i = src row idx[i]; scatter == 1 (K5): dst row idx[i] = src row
// i. lds and ldd are the row strides in bytes; m bounds the indexed side's
// rows. Returns 0 or a cudaError_t code; never synchronises.
int conflux_row_move(int scatter, const void* src, long long lds, void* dst,
                     long long ldd, const long long* idx, int rows,
                     long long m, long long row_bytes, void* stream) {
  if (rows < 1 || row_bytes < 1) return cudaErrorInvalidValue;
  const uintptr_t align = reinterpret_cast<uintptr_t>(src) |
                          reinterpret_cast<uintptr_t>(dst) |
                          static_cast<uintptr_t>(lds) |
                          static_cast<uintptr_t>(ldd) |
                          static_cast<uintptr_t>(row_bytes);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (align % 16 == 0)
    return launch<uint4>(scatter, src, lds, dst, ldd, idx, rows, m,
                         row_bytes, s);
  if (align % 4 == 0)
    return launch<uint32_t>(scatter, src, lds, dst, ldd, idx, rows, m,
                            row_bytes, s);
  if (align % 2 == 0)
    return launch<uint16_t>(scatter, src, lds, dst, ldd, idx, rows, m,
                            row_bytes, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
