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
// kernels keep a few whole-row DMAs in flight (group = 8), with the row
// ids scalar-prefetched. Hopper has the same engine: TMA bulk copies.
//   * Bulk route, where both row starts, both strides and the row width
//     are multiples of 16 bytes (TMA's rule): a CTA of one warp per item,
//     an item being one chunk of up to 16 KB of one wide row, or up to 32
//     whole narrow rows (one lane each), so a 6 KB panel row is one copy.
//     Each valid row of the item is one cp.async.bulk into the CTA's
//     16 KB of shared memory, completing on one mbarrier, then one bulk
//     copy out. Up to 14 such CTAs fit an SM, so the block scheduler keeps
//     some 200 KB of rows in flight per SM with no registers spent on the
//     data. (A ring of slots walked by persistent CTAs, with the indices
//     read ahead, measured 1-4 % slower at crout's shapes on an H100,
//     experiments/torch_kernel_ab.py.)
//   * Word route, for everything else: a block of 256 threads copies a
//     16 KB chunk of one row (4 words per thread, all loads issued before
//     the stores) in 4-byte or 2-byte words as the alignment allows; the
//     grid is (rows, chunks per row) and each block reads its own index.
// Any row stride: the split compaction gathers from a column slice of T.

#include <cuda_runtime.h>

#include <cstdint>

#include "wgmma_tile.cuh"

namespace {

// ------------------------------------------------------------ word route

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
cudaError_t launch_words(int scatter, const void* src, long long lds,
                         void* dst, long long ldd, const long long* idx,
                         int rows, long long m, long long row_bytes,
                         cudaStream_t stream) {
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

// ------------------------------------------------------------ bulk route

constexpr int kItemBytes = 16384;         // shared memory of one CTA
constexpr int kMaxGroup = 32;             // narrow rows per item, one a lane

struct BulkArgs {
  const char* src;
  char* dst;
  long long lds, ldd;          // row strides, bytes
  const long long* idx;
  long long m;                 // rows of the indexed side
  long long row_bytes;
  int rows;                    // len(idx)
  int group;                   // rows per item (1: chunks of a wide row)
  int chunk;                   // bytes per row per item
  int chunks;                  // items per row group
  int scatter;
};

// One CTA of one warp moves item blockIdx.x: lane l's row of it (row
// group * item / chunks + l, at byte offset chunk * (item % chunks)) is
// one bulk copy into the CTA's shared memory, all completing on one
// mbarrier, then one bulk copy out.
__global__ void __launch_bounds__(32) bulk_move_kernel(BulkArgs a) {
  using namespace conflux_wgmma;
  __shared__ __align__(128) uint8_t buf[kItemBytes];
  __shared__ uint64_t full;
  const int lane = threadIdx.x;
  const long long item = blockIdx.x;
  const long long i = (item / a.chunks) * a.group + lane;
  const long long r = lane < a.group && i < a.rows ? a.idx[i] : -1;
  const bool ok = r >= 0 && r < a.m;
  const unsigned valid = __ballot_sync(0xffffffffu, ok);
  if (valid == 0) return;
  const long long off = (item % a.chunks) * a.chunk;
  const long long left = a.row_bytes - off;
  const int bytes = static_cast<int>(left < a.chunk ? left : a.chunk);
  if (lane == 0) {
    mbar_init(&full, 1);
    fence_barrier_init();
    mbar_expect_tx(&full, __popc(valid) * bytes);
  }
  __syncwarp();
  if (ok)
    bulk_load(buf + lane * bytes, a.src + (a.scatter ? i : r) * a.lds + off,
              bytes, &full);
  mbar_wait(&full, 0);
  if (ok) {
    bulk_store(a.dst + (a.scatter ? r : i) * a.ldd + off, buf + lane * bytes,
               bytes);
    bulk_commit();
    bulk_wait_all();
  }
}

cudaError_t launch_bulk(int scatter, const void* src, long long lds,
                        void* dst, long long ldd, const long long* idx,
                        int rows, long long m, long long row_bytes,
                        cudaStream_t stream) {
  BulkArgs a;
  a.src = static_cast<const char*>(src);
  a.dst = static_cast<char*>(dst);
  a.lds = lds;
  a.ldd = ldd;
  a.idx = idx;
  a.m = m;
  a.row_bytes = row_bytes;
  a.rows = rows;
  a.scatter = scatter;
  const long long fit = kItemBytes / row_bytes;
  a.group = static_cast<int>(fit < 1 ? 1 : fit > kMaxGroup ? kMaxGroup : fit);
  a.chunk = static_cast<int>(row_bytes < kItemBytes ? row_bytes : kItemBytes);
  const long long chunks = (row_bytes + a.chunk - 1) / a.chunk;
  const long long items = (rows + a.group - 1) / a.group * chunks;
  if (items > 0x7fffffffLL) return cudaErrorInvalidValue;
  a.chunks = static_cast<int>(chunks);
  bulk_move_kernel<<<static_cast<unsigned>(items), 32, 0, stream>>>(a);
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
// rows. *route receives the kernel launched: 1 the TMA bulk-copy route
// (row starts, strides and width all multiples of 16 bytes), 0 the word
// copies. Returns 0 or a cudaError_t code; never synchronises.
int conflux_row_move(int scatter, const void* src, long long lds, void* dst,
                     long long ldd, const long long* idx, int rows,
                     long long m, long long row_bytes, void* stream,
                     int* route) {
  if (rows < 1 || row_bytes < 1) return cudaErrorInvalidValue;
  const uintptr_t align = reinterpret_cast<uintptr_t>(src) |
                          reinterpret_cast<uintptr_t>(dst) |
                          static_cast<uintptr_t>(lds) |
                          static_cast<uintptr_t>(ldd) |
                          static_cast<uintptr_t>(row_bytes);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  *route = align % 16 == 0;
  if (align % 16 == 0)
    return launch_bulk(scatter, src, lds, dst, ldd, idx, rows, m, row_bytes,
                       s);
  if (align % 4 == 0)
    return launch_words<uint32_t>(scatter, src, lds, dst, ldd, idx, rows, m,
                                  row_bytes, s);
  if (align % 2 == 0)
    return launch_words<uint16_t>(scatter, src, lds, dst, ldd, idx, rows, m,
                                  row_bytes, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
