// K3: the fused trailing (Schur complement) update R[:, c0:c1] -= A @ B, by
// hand for Hopper (sm_90a).
//
// Replaces the TPU kernel conflux_tpu/ops/pallas_gemm.py:schur_update_pallas
// (kernels _acc_kernel and _acc_kernel_x3, operand split _split_hi_lo).
// Same arithmetic:
//   R [m, ncols] f32 (bf16 in mode 'bf16out'), A [m, k] f32, B [k, c1-c0] f32;
//   each operand element x splits as hi = bf16_rn(x), lo = bf16_rn(x - hi);
//   'high' accumulates hi*hi + hi*lo + lo*hi in fp32 (lo*lo dropped, as
//   XLA's Precision.HIGH drops it), 'bf16'/'bf16out' accumulate hi*hi only;
//   then R = round(float(R) - acc) into R's own type, once, in place.
// The split is the round-to-nearest-even split of the TPU kernel and of the
// port's ops/tri._split_hi_lo, so operand values match bit for bit and only
// the fp32 summation order differs from the plain version.
//
// What bounds it on the H100: at the flat LU's shapes (k = 1536, an output
// span of up to 32768 x 31232) it is a large GEMM with a read-modify-write
// epilogue: 2k (x3 in 'high') bf16 FLOPs per output element against 8
// bytes of R traffic, so the tensor cores are the limit, and only wgmma
// reaches their rate. wgmma reads bf16 from shared memory, so:
//   * a split pass (wgmma_split.cuh) writes bf16 hi (and, in 'high', lo)
//     copies of A and B into a workspace the caller allocates, with row
//     strides padded to 16 bytes for TMA; at flat's first update that moves
//     ~0.8 GB (~0.25 ms at the card's memory rate) against a ~14 ms product,
//     and it halves the operand bytes of the one-pass modes;
//   * the product is the warp-specialised, persistent TMA + wgmma mainloop
//     of wgmma_split.cuh ([128, 256] tiles, one accumulator for the three
//     products of 'high');
//   * the epilogue reads each R element once into registers (the first
//     quarter of a consumer's block before its mainloop, each next quarter
//     while the current one is written), subtracts in fp32, rounds once into
//     R's type and writes back through 128-byte-swizzled staging and TMA
//     stores, which drain while the next tile computes. Where R's base, row
//     stride or span width breaks TMA's 16-byte rules (a span starting or
//     ending at an odd column), the registers are stored directly,
//     bounds-masked.
// Row strides of R, A and B are arguments, so the strided span R[:, c0:c1]
// is updated where it lies: R's tensor map takes R's row stride, not the
// span's width. The kernel takes every call; the route it reports is for
// the caller's counters.

#include <algorithm>

#include "wgmma_split.cuh"

namespace {

using namespace conflux_split;

// per consumer: a quarter (64 columns) of its [64, 256] block, f32 as two
// [64][32] boxes or bf16 as one [64][64] box, each row 128 bytes
constexpr int kCStageBytes = 16384;
constexpr int kCBoxBytes = 8192;

template <bool kX3>
constexpr size_t smem_bytes() {
  return (size_t)Ring<kX3>::kBytes + kConsumers * kCStageBytes +
         2 * Ring<kX3>::kStages * sizeof(uint64_t) + 1024;  // alignment slack
}

enum Route { kRouteWgmma = 1 };

__device__ __forceinline__ float ld1(const float* p) { return *p; }
__device__ __forceinline__ float ld1(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 ld2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void st1(float* p, float x) { *p = x; }
__device__ __forceinline__ void st1(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}
__device__ __forceinline__ void st2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void st2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// this thread's R elements of quarter q: v[4 jj + 2 h + e] is row
// gr0 + 8 h, column gc0 + 64 q + 8 jj + e (the wgmma accumulator layout);
// zero outside [0, m) x [0, nt)
template <typename T>
__device__ __forceinline__ void load_quarter(const T* r, int ldr, int m,
                                             int nt, int gr0, int gc0, int q,
                                             bool vec2, float (&v)[32]) {
#pragma unroll
  for (int jj = 0; jj < 8; ++jj)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gr = gr0 + 8 * h, gc = gc0 + 64 * q + 8 * jj;
      float x0 = 0.f, x1 = 0.f;
      if (gr < m && gc < nt) {
        const T* p = r + (size_t)gr * ldr + gc;
        if (vec2 && gc + 1 < nt) {
          const float2 x = ld2(p);
          x0 = x.x;
          x1 = x.y;
        } else {
          x0 = ld1(p);
          if (gc + 1 < nt) x1 = ld1(p + 1);
        }
      }
      v[4 * jj + 2 * h] = x0;
      v[4 * jj + 2 * h + 1] = x1;
    }
}

template <bool kX3, typename T>
__global__ void __launch_bounds__(kThreads, 1) schur_update_wgmma_kernel(
    const __grid_constant__ Maps maps,
    const __grid_constant__ CUtensorMap map_r, bool tma_r, T* r, int ldr,
    int m, int nt, int k, int tiles_m, int tiles_n) {
  using Rg = Ring<kX3>;
  constexpr bool kF32 = sizeof(T) == 4;
  extern __shared__ uint8_t k3_smem_raw[];
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(k3_smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* cstage = ring + Rg::kBytes;
  uint64_t* full =
      reinterpret_cast<uint64_t*>(cstage + kConsumers * kCStageBytes);
  uint64_t* empty = full + Rg::kStages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < Rg::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    fence_barrier_init();
  }
  __syncthreads();
  const int tiles = tiles_m * tiles_n;
  const int nk = (k + kBK - 1) / kBK;
  const int wg = threadIdx.x / 128;

  if (wg == 0) {
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      Pos pos;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        int row0, col0;
        tile_origin(t, tiles_m, tiles_n, row0, col0);
        produce<kX3>(maps, ring, full, empty, pos, row0, col0, nk);
      }
    }
    return;
  }

  setmaxnreg_inc<232>();
  const int cw = wg - 1;                       // this consumer's 64 rows
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32;
  const int rl = 16 * warp + lane / 4;         // row in the consumer's block
  const bool vec2 = ldr % 2 == 0 &&
                    reinterpret_cast<uintptr_t>(r) % (2 * sizeof(T)) == 0;
  uint8_t* cs = cstage + cw * kCStageBytes;
  float acc[128];
  Pos pos;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    int row0, col0;
    tile_origin(t, tiles_m, tiles_n, row0, col0);
    const int gr0 = row0 + 64 * cw + rl;
    const int gc0 = col0 + 2 * (lane % 4);
    float cur[32], nxt[32];
    // R's first quarter is in flight during the mainloop
    load_quarter(r, ldr, m, nt, gr0, gc0, 0, vec2, cur);
    consume<kX3>(acc, ring, full, empty, pos, cw, tid, nk);

#pragma unroll
    for (int q = 0; q < kBN / 64; ++q) {
      if (q + 1 < kBN / 64)
        load_quarter(r, ldr, m, nt, gr0, gc0, q + 1, vec2, nxt);
      float (&o)[32] = cur;     // R - acc, in place
#pragma unroll
      for (int i = 0; i < 32; ++i) o[i] = __fsub_rn(cur[i], acc[32 * q + i]);
      if (tma_r) {
        // registers -> the swizzled staging -> TMA store; row rl + 8 h has
        // (rl + 8 h) % 8 == lane / 4, so a 16-byte chunk c lands at c ^ (lane / 4)
        if (tid == 0) bulk_wait_read<0>();     // the staging is free
        named_sync(1 + cw, 128);
#pragma unroll
        for (int jj = 0; jj < 8; ++jj)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float x0 = o[4 * jj + 2 * h], x1 = o[4 * jj + 2 * h + 1];
            uint8_t* row = cs + (rl + 8 * h) * 128;
            if (kF32) {
              const int chunk = 2 * (jj % 4) + (lane % 4) / 2;
              st2(reinterpret_cast<float*>(row + (jj / 4) * kCBoxBytes +
                                           ((chunk ^ (lane / 4)) * 16) +
                                           8 * (lane % 2)),
                  x0, x1);
            } else {
              st2(reinterpret_cast<__nv_bfloat16*>(
                      row + ((jj ^ (lane / 4)) * 16) + 4 * (lane % 4)),
                  x0, x1);
            }
          }
        fence_proxy_async();     // the writes, visible to the TMA store
        named_sync(1 + cw, 128);
        if (tid == 0) {
          tma_store_2d(&map_r, cs, col0 + 64 * q, row0 + 64 * cw);
          if (kF32)
            tma_store_2d(&map_r, cs + kCBoxBytes, col0 + 64 * q + 32,
                         row0 + 64 * cw);
          bulk_commit();
        }
      } else {
#pragma unroll
        for (int jj = 0; jj < 8; ++jj)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int gr = gr0 + 8 * h, gc = gc0 + 64 * q + 8 * jj;
            if (gr >= m || gc >= nt) continue;
            T* p = r + (size_t)gr * ldr + gc;
            const float x0 = o[4 * jj + 2 * h], x1 = o[4 * jj + 2 * h + 1];
            if (vec2 && gc + 1 < nt) {
              st2(p, x0, x1);
            } else {
              st1(p, x0);
              if (gc + 1 < nt) st1(p + 1, x1);
            }
          }
      }
      if (q + 1 < kBN / 64)
#pragma unroll
        for (int i = 0; i < 32; ++i) cur[i] = nxt[i];
    }
  }
  if (tid == 0) bulk_wait_all();     // the TMA stores are done
}

size_t align256(size_t b) { return (b + 255) / 256 * 256; }

// the workspace's split copies: A hi/lo [m, padded(k)], B hi/lo
// [k, padded(nt)] bf16, each 256-byte aligned
struct Layout {
  size_t a_bytes, b_bytes;
  int copies;                         // 2 (hi, lo) in 'high', else 1
  size_t total() const { return copies * (a_bytes + b_bytes); }
};

Layout layout(int m, int nt, int k, int passes) {
  return {align256((size_t)m * padded(k) * 2),
          align256((size_t)k * padded(nt) * 2), passes == 3 ? 2 : 1};
}

int sm_count() {
  int sms = 132, dev = 0;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

template <bool kX3, typename T>
cudaError_t launch(const Maps& maps, T* r, int ldr, int m, int nt, int k,
                   cudaStream_t stream) {
  constexpr CUtensorMapDataType type =
      sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                     : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap map_r{};
  // TMA stores clip a box at the span's last column only to 16 bytes, so
  // the span's width must be a multiple of 16 bytes too (a ragged width
  // would overwrite R's next columns)
  const bool tma_r = reinterpret_cast<uintptr_t>(r) % 16 == 0 &&
                     ((size_t)ldr * sizeof(T)) % 16 == 0 &&
                     ((size_t)nt * sizeof(T)) % 16 == 0 && ldr >= nt;
  if (tma_r) {
    const cudaError_t e = make_map(&map_r, type, sizeof(T), r, m, nt, ldr, 64,
                                   128 / sizeof(T));
    if (e != cudaSuccess) return e;
  }
  auto kernel = schur_update_wgmma_kernel<kX3, T>;
  const size_t smem = smem_bytes<kX3>();
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const long long tiles_m = (m + kBM - 1) / kBM;
  const long long tiles_n = (nt + kBN - 1) / kBN;
  if (tiles_m * tiles_n > 0x7fffffffLL) return cudaErrorInvalidValue;
  const long long tiles = tiles_m * tiles_n;
  const int sms = sm_count();
  const int grid = static_cast<int>(tiles < sms ? tiles : sms);
  kernel<<<grid, kThreads, smem, stream>>>(
      maps, map_r, tma_r, r, ldr, m, nt, k, static_cast<int>(tiles_m),
      static_cast<int>(tiles_n));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dynamic shared memory a CTA of the product uses, in 'high' (ptxas
// reports static memory only)
int conflux_schur_update_smem_bytes() {
  return static_cast<int>(smem_bytes<true>());
}

// bytes of workspace the split copies of one call need
long long conflux_schur_update_workspace_bytes(int m, int nt, int k,
                                               int passes) {
  return static_cast<long long>(layout(m, nt, k, passes).total());
}

const char* conflux_schur_update_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The split pass alone, for checking it: x [rows, cols] f32 (row stride
// ldx) into bf16 hi and, unless lo is null, lo (row stride lds). Returns 0
// or a cudaError_t code; never synchronises.
int conflux_split_hi_lo(const float* x, int ldx, int rows, int cols,
                        void* hi, void* lo, int lds, void* stream) {
  if (rows < 1 || cols < 1) return cudaErrorInvalidValue;
  SplitArgs sp{};
  sp.x[0] = x;
  sp.ldx[0] = ldx;
  sp.rows[0] = rows;
  sp.cols[0] = cols;
  sp.lds[0] = lds;
  sp.hi[0] = static_cast<__nv_bfloat16*>(hi);
  sp.lo[0] = static_cast<__nv_bfloat16*>(lo);
  const dim3 grid(std::min((cols + 255) / 256, 32), std::min(rows, 1024), 1);
  split_hi_lo_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(sp);
  return cudaGetLastError();
}

// R[:, c0:c0+nt] -= A @ B on `stream`, where r points at R[0, c0].
// r_bf16: R is bfloat16 (mode 'bf16out'), else float32. passes: 3 for
// 'high', 1 for 'bf16'/'bf16out'. ws holds ws_bytes bytes, at least
// conflux_schur_update_workspace_bytes(m, nt, k, passes), 256-byte
// aligned. *route receives the kernel launched (1: split pass + wgmma).
// Returns 0 or a cudaError_t code (a refused launch included); never
// synchronises.
int conflux_schur_update(void* r, int r_bf16, int ldr, const float* a,
                         int lda, const float* b, int ldb, int m, int nt,
                         int k, int passes, void* ws, long long ws_bytes,
                         void* stream, int* route) {
  if (m < 1 || nt < 1 || k < 1 || (passes != 1 && passes != 3))
    return cudaErrorInvalidValue;
  const Layout lay = layout(m, nt, k, passes);
  if (ws_bytes < static_cast<long long>(lay.total()) ||
      reinterpret_cast<uintptr_t>(ws) % 256 != 0)
    return cudaErrorInvalidValue;
  const bool x3 = passes == 3;
  uint8_t* w = static_cast<uint8_t*>(ws);
  SplitArgs sp{};
  sp.x[0] = a;
  sp.x[1] = b;
  sp.ldx[0] = lda;
  sp.ldx[1] = ldb;
  sp.rows[0] = m;
  sp.rows[1] = k;
  sp.cols[0] = k;
  sp.cols[1] = nt;
  sp.lds[0] = padded(k);
  sp.lds[1] = padded(nt);
  sp.hi[0] = reinterpret_cast<__nv_bfloat16*>(w);
  sp.hi[1] = reinterpret_cast<__nv_bfloat16*>(w + lay.a_bytes);
  sp.lo[0] = x3 ? reinterpret_cast<__nv_bfloat16*>(w + lay.a_bytes +
                                                   lay.b_bytes)
                : nullptr;
  sp.lo[1] = x3 ? reinterpret_cast<__nv_bfloat16*>(w + 2 * lay.a_bytes +
                                                   lay.b_bytes)
                : nullptr;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int max_cols = nt > k ? nt : k;
  const int max_rows = m > k ? m : k;
  const dim3 sgrid(std::min((max_cols + 255) / 256, 32),
                   std::min(max_rows, 1024), 2);
  split_hi_lo_kernel<<<sgrid, 256, 0, s>>>(sp);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;

  Maps maps;
  e = make_maps(&maps, sp, m, nt, k, x3);
  if (e != cudaSuccess) return e;
  *route = kRouteWgmma;
  if (x3)   // 'high' updates a float32 R
    return r_bf16 ? cudaErrorInvalidValue
                  : launch<true>(maps, static_cast<float*>(r), ldr, m, nt, k,
                                 s);
  return r_bf16 ? launch<false>(maps, static_cast<__nv_bfloat16*>(r), ldr, m,
                                nt, k, s)
                : launch<false>(maps, static_cast<float*>(r), ldr, m, nt, k,
                                s);
}

}  // extern "C"
