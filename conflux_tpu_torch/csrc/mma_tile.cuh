// The tensor-core mainloop shared by K3 (schur_update.cu) and K2
// (bigk_gemm.cu): one CTA of 8 warps accumulates a [kBM, kBN] tile of
// A @ B over a range of K, with f32 A and B in device memory, in fp32
// registers, through mma.sync m16n8k16 on bf16 operands.
//
//   * a kStages-deep cp.async ring of raw f32 K chunks in shared memory
//     (16-byte copies where the operands are 16-byte aligned, 4-byte ones
//     otherwise; zero-filled past the ragged edges and past the K range);
//   * each warp reads its fragments straight from the f32 chunk (padded
//     rows: no bank conflicts) and splits them in registers into
//     hi = bf16_rn(x) and lo = bf16_rn(x - hi), the round-to-nearest-even
//     split of conflux_tpu/ops/pallas_gemm._split_hi_lo and of the port's
//     ops/tri._split_hi_lo, so the operand values match the plain versions
//     bit for bit and only the fp32 summation order differs;
//   * kX3 ('high') accumulates hi*hi + hi*lo + lo*hi (lo*lo dropped, as
//     XLA's Precision.HIGH drops it); otherwise hi*hi only.
// Row strides are arguments; nothing needs to divide anything.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace conflux_mma {

constexpr int kBM = 256;                     // output tile rows
constexpr int kBN = 128;                     // output tile columns
constexpr int kBK = 32;                      // K chunk
constexpr int kStages = 3;                   // cp.async ring depth
constexpr int kThreads = 256;                // 8 warps: 4 x 2 over the tile
constexpr int kWM = 64;                      // warp sub-tile rows
constexpr int kWN = 64;                      // warp sub-tile columns
constexpr int kWarpsN = kBN / kWN;
constexpr int kMT = kWM / 16;                // m16 tiles per warp
constexpr int kNT = kWN / 8;                 // n8 tiles per warp
// row strides in floats: A's 8-byte fragment pairs and B's 4-byte fragment
// elements then hit 32 distinct banks per access; rows stay 16-byte aligned
constexpr int kLdA = kBK + 8;
constexpr int kLdB = kBN + 4;
constexpr int kLdC = kBN + 4;
constexpr int kStageA = kBM * kLdA;          // floats
constexpr int kStageFloats = kStageA + kBK * kLdB;
constexpr size_t kSmemBytes = sizeof(float) * kStages * kStageFloats;
constexpr int kGroupM = 8;                   // row tiles per L2 group
static_assert(kStageFloats % 4 == 0, "stages stay 16-byte aligned");
static_assert((kBM / kWM) * kWarpsN * 32 == kThreads, "warp layout");
static_assert(kBM * kLdC <= kStages * kStageFloats,
              "the accumulator tile reuses the operand ring");

using Acc = float[kMT][kNT][4];

struct Operands {
  const float* a;   // A [m, k], row stride lda
  const float* b;   // B [k, nt], row stride ldb
  int lda, ldb;
  int m, nt;        // output rows and columns
  int k;            // end of the K range: A columns and B rows from here on
                    // read as zero
};

// global -> shared copies of `bytes` (<= the copy size; the rest of the
// destination is zero-filled and nothing past `bytes` is read)
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(s), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(kPending) : "memory");
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// x ~= hi + lo for a pair of consecutive fragment elements (x0 in the low
// half): hi = bf16_rn(x), lo = bf16_rn(x - hi), exactly _split_hi_lo
template <bool kX3>
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  hi = as_u32(h);
  if (kX3)
    lo = as_u32(__floats2bfloat162_rn(__fsub_rn(x0, __low2float(h)),
                                      __fsub_rn(x1, __high2float(h))));
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// grouped tile order: kGroupM row tiles, then the next column tile, so the
// A and B tiles in flight at once stay in the L2
__device__ __forceinline__ void tile_origin(int pid, int tiles_m,
                                            int tiles_n, int& row0,
                                            int& col0) {
  const int per_group = kGroupM * tiles_n;
  const int first_m = (pid / per_group) * kGroupM;
  const int group_m = min(tiles_m - first_m, kGroupM);
  row0 = (first_m + (pid % per_group) % group_m) * kBM;
  col0 = ((pid % per_group) / group_m) * kBN;
}

// start the copies of K chunk [k0, k0 + kBK) into one ring stage
template <bool kVec>
__device__ __forceinline__ void load_stage(const Operands& a, float* st,
                                           int k0, int row0, int col0,
                                           int tid) {
  float* sa = st;
  float* sb = st + kStageA;
  if (kVec) {
#pragma unroll
    for (int i = 0; i < kBM * kBK / 4 / kThreads; ++i) {
      const int idx = tid + i * kThreads;
      const int r = idx / (kBK / 4), c = 4 * (idx % (kBK / 4));
      const int gr = row0 + r, gk = k0 + c;
      const int n = gr < a.m ? max(0, min(4, a.k - gk)) : 0;
      const float* src = n ? a.a + (size_t)gr * a.lda + gk : a.a;
      cp_async16(sa + r * kLdA + c, src, 4 * n);
    }
#pragma unroll
    for (int i = 0; i < kBK * kBN / 4 / kThreads; ++i) {
      const int idx = tid + i * kThreads;
      const int r = idx / (kBN / 4), c = 4 * (idx % (kBN / 4));
      const int gk = k0 + r, gc = col0 + c;
      const int n = gk < a.k ? max(0, min(4, a.nt - gc)) : 0;
      const float* src = n ? a.b + (size_t)gk * a.ldb + gc : a.b;
      cp_async16(sb + r * kLdB + c, src, 4 * n);
    }
  } else {
#pragma unroll
    for (int i = 0; i < kBM * kBK / kThreads; ++i) {
      const int idx = tid + i * kThreads;
      const int r = idx / kBK, c = idx % kBK;
      const int gr = row0 + r, gk = k0 + c;
      const bool in = gr < a.m && gk < a.k;
      cp_async4(sa + r * kLdA + c, in ? a.a + (size_t)gr * a.lda + gk : a.a,
                in ? 4 : 0);
    }
#pragma unroll
    for (int i = 0; i < kBK * kBN / kThreads; ++i) {
      const int idx = tid + i * kThreads;
      const int r = idx / kBN, c = idx % kBN;
      const int gk = k0 + r, gc = col0 + c;
      const bool in = gk < a.k && gc < a.nt;
      cp_async4(sb + r * kLdB + c, in ? a.b + (size_t)gk * a.ldb + gc : a.b,
                in ? 4 : 0);
    }
  }
}

// acc = A[row0 : row0 + kBM, k_begin : a.k] @ B[k_begin : a.k, col0 :
// col0 + kBN] (bf16 products, fp32 sums); k_begin is a multiple of kBK.
// `smem` holds kSmemBytes. Ends with every warp done with the ring.
template <bool kX3, bool kVec>
__device__ __forceinline__ void mainloop(const Operands& a, float* smem,
                                         int row0, int col0, int k_begin,
                                         Acc& acc) {
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int wr = (warp / kWarpsN) * kWM, wc = (warp % kWarpsN) * kWN;
  const int g = lane >> 2, q = lane & 3;      // fragment row, column pair

#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int nk = (a.k - k_begin + kBK - 1) / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load_stage<kVec>(a, smem + s * kStageFloats,
                                 k_begin + s * kBK, row0, col0, tid);
    cp_async_commit();
  }

  for (int kc = 0; kc < nk; ++kc) {
    cp_async_wait<kStages - 2>();   // chunk kc has landed, for this thread
    __syncthreads();                // ... and for all; stage kc-1 is free
    const int next = kc + kStages - 1;
    if (next < nk)
      load_stage<kVec>(a, smem + (next % kStages) * kStageFloats,
                       k_begin + next * kBK, row0, col0, tid);
    cp_async_commit();

    const float* sa = smem + (kc % kStages) * kStageFloats;
    const float* sb = sa + kStageA;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t ah[kMT][4], al[kMT][4], bh[kNT][2], bl[kNT][2];
#pragma unroll
      for (int i = 0; i < kMT; ++i) {
        const float* p = sa + (wr + 16 * i + g) * kLdA + kk + 2 * q;
        const float2 x0 = *reinterpret_cast<const float2*>(p);
        const float2 x1 = *reinterpret_cast<const float2*>(p + 8 * kLdA);
        const float2 x2 = *reinterpret_cast<const float2*>(p + 8);
        const float2 x3 = *reinterpret_cast<const float2*>(p + 8 * kLdA + 8);
        split2<kX3>(x0.x, x0.y, ah[i][0], al[i][0]);
        split2<kX3>(x1.x, x1.y, ah[i][1], al[i][1]);
        split2<kX3>(x2.x, x2.y, ah[i][2], al[i][2]);
        split2<kX3>(x3.x, x3.y, ah[i][3], al[i][3]);
      }
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const float* p = sb + (kk + 2 * q) * kLdB + wc + 8 * j + g;
        split2<kX3>(p[0], p[kLdB], bh[j][0], bl[j][0]);
        split2<kX3>(p[8 * kLdB], p[9 * kLdB], bh[j][1], bl[j][1]);
      }
#pragma unroll
      for (int i = 0; i < kMT; ++i)
#pragma unroll
        for (int j = 0; j < kNT; ++j) mma_bf16(acc[i][j], ah[i], bh[j]);
      if (kX3) {
#pragma unroll
        for (int i = 0; i < kMT; ++i)
#pragma unroll
          for (int j = 0; j < kNT; ++j) mma_bf16(acc[i][j], ah[i], bl[j]);
#pragma unroll
        for (int i = 0; i < kMT; ++i)
#pragma unroll
          for (int j = 0; j < kNT; ++j) mma_bf16(acc[i][j], al[i], bh[j]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();                  // every warp is done with the ring
}

// the accumulator tile into shared memory, row stride kLdC (it reuses the
// ring), readable by every thread after the barrier at the end
__device__ __forceinline__ void stage_acc(const Acc& acc, float* cs) {
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int wr = (warp / kWarpsN) * kWM, wc = (warp % kWarpsN) * kWN;
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      float* p = cs + (wr + 16 * i + g) * kLdC + wc + 8 * j + 2 * q;
      *reinterpret_cast<float2*>(p) = make_float2(acc[i][j][0], acc[i][j][1]);
      *reinterpret_cast<float2*>(p + 8 * kLdC) =
          make_float2(acc[i][j][2], acc[i][j][3]);
    }
  __syncthreads();
}

__device__ __forceinline__ float load_r(const float* p) { return *p; }
__device__ __forceinline__ float load_r(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_r(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_r(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// 16-byte copies need 16-byte aligned rows of A and B
inline bool operands_16b_aligned(const Operands& a) {
  return reinterpret_cast<uintptr_t>(a.a) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(a.b) % 16 == 0 && a.lda % 4 == 0 &&
         a.ldb % 4 == 0;
}

}  // namespace conflux_mma
