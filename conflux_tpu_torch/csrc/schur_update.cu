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
// epilogue. Per output element it does 2k (x3 in 'high') bf16 FLOPs against
// 8 bytes of R traffic, so the tensor cores and the operand stream are the
// limits: the f32 A and B tiles are re-read from the L2 once per output
// tile, 43 FLOP per operand byte per pass at a [256, 128] tile. Measured
// on the card, the one-pass modes are bound by that stream (a [128, 128]
// tile, 1.33x the bytes, ran 1.35x slower) and 'high' by the rate at
// which one CTA per SM starts its MMAs. The TPU kernel holds whole-K
// operand tiles in VMEM; here a [256, 1536] f32 A tile alone is 1.5 MB,
// far over the 227 KB of shared memory, so:
//   * one CTA (8 warps, 4 x 2, each a [64, 64] sub-tile) per [256, 128]
//     output tile; K in chunks of 32;
//   * a 3-stage cp.async ring of raw f32 chunks in shared memory (16-byte
//     copies where the operands are 16-byte aligned, 4-byte ones
//     otherwise; zero-filled past the ragged edges), so two chunks are in
//     flight while the tensor cores work on the third;
//   * each warp reads its mma.sync m16n8k16 fragments straight from the
//     f32 chunk (padded rows: no bank conflicts) and splits them into hi/lo
//     bf16 in registers, so no hi/lo copy of A or B is ever stored, in
//     device memory or in shared memory;
//   * the accumulator goes through shared memory, and the epilogue reads
//     each R element once, subtracts in fp32, rounds once, writes it back
//     (bounds-masked: no divisibility requirement on m, k, c0 or c1);
//   * tiles are visited in groups of 8 row tiles (2048 rows), so the A and
//     B tiles in flight at once (~24 MB) stay in the 50 MB L2.
// Row strides of R, A and B are arguments, so the strided span R[:, c0:c1]
// is updated where it lies. wgmma and TMA are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

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

struct Args {
  void* r;          // &R[0, c0]
  const float* a;
  const float* b;
  int ldr, lda, ldb;
  int m, nt, k;     // R span [m, nt], A [m, k], B [k, nt]
  int tiles_m, tiles_n;
};

__device__ __forceinline__ float load_r(const float* p) { return *p; }
__device__ __forceinline__ float load_r(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_r(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_r(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

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

// start the copies of K chunk [k0, k0 + kBK) into one ring stage
template <bool kVec>
__device__ __forceinline__ void load_stage(Args a, float* st, int k0,
                                           int row0, int col0, int tid) {
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

template <bool kX3, bool kVec, typename T>
__global__ void __launch_bounds__(kThreads) schur_update_kernel(Args a) {
  extern __shared__ __align__(128) float smem[];

  // grouped tile order: kGroupM row tiles, then the next column tile
  const int pid = blockIdx.x;
  const int per_group = kGroupM * a.tiles_n;
  const int first_m = (pid / per_group) * kGroupM;
  const int group_m = min(a.tiles_m - first_m, kGroupM);
  const int tm = first_m + (pid % per_group) % group_m;
  const int tn = (pid % per_group) / group_m;
  const int row0 = tm * kBM, col0 = tn * kBN;

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int wr = (warp / kWarpsN) * kWM, wc = (warp % kWarpsN) * kWN;
  const int g = lane >> 2, q = lane & 3;      // fragment row, column pair

  float acc[kMT][kNT][4];
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int nk = (a.k + kBK - 1) / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load_stage<kVec>(a, smem + s * kStageFloats, s * kBK, row0,
                                 col0, tid);
    cp_async_commit();
  }

  for (int kc = 0; kc < nk; ++kc) {
    cp_async_wait<kStages - 2>();   // chunk kc has landed, for this thread
    __syncthreads();                // ... and for all; stage kc-1 is free
    const int next = kc + kStages - 1;
    if (next < nk)
      load_stage<kVec>(a, smem + (next % kStages) * kStageFloats,
                       next * kBK, row0, col0, tid);
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

  // epilogue: accumulator tile through shared memory, then one
  // read-subtract-round-write of each R element
  float* cs = smem;
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
  T* r = static_cast<T*>(a.r);
  for (int idx = tid; idx < kBM * kBN; idx += kThreads) {
    const int i = idx / kBN, j = idx % kBN;
    const int gr = row0 + i, gc = col0 + j;
    if (gr < a.m && gc < a.nt) {
      T* p = r + (size_t)gr * a.ldr + gc;
      store_r(p, __fsub_rn(load_r(p), cs[i * kLdC + j]));
    }
  }
}

template <bool kX3, bool kVec, typename T>
cudaError_t launch(const Args& args, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      schur_update_kernel<kX3, kVec, T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBytes));
  if (e != cudaSuccess) return e;
  const long long tiles = (long long)args.tiles_m * args.tiles_n;
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  schur_update_kernel<kX3, kVec, T>
      <<<static_cast<unsigned>(tiles), kThreads, kSmemBytes, stream>>>(args);
  return cudaGetLastError();
}

template <bool kX3, typename T>
cudaError_t launch_aligned(const Args& args, cudaStream_t stream) {
  // 16-byte copies need 16-byte aligned rows of A and B
  const bool vec = (reinterpret_cast<uintptr_t>(args.a) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(args.b) % 16 == 0) &&
                   args.lda % 4 == 0 && args.ldb % 4 == 0;
  return vec ? launch<kX3, true, T>(args, stream)
             : launch<kX3, false, T>(args, stream);
}

}  // namespace

extern "C" {

// dynamic shared memory a CTA uses (ptxas reports static memory only)
int conflux_schur_update_smem_bytes() { return static_cast<int>(kSmemBytes); }

const char* conflux_schur_update_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// R[:, c0:c0+nt] -= A @ B on `stream`, where r points at R[0, c0].
// r_bf16: R is bfloat16 (mode 'bf16out'), else float32. passes: 3 for
// 'high', 1 for 'bf16'/'bf16out'. Returns 0 or a cudaError_t code (a
// refused launch included); never synchronises.
int conflux_schur_update(void* r, int r_bf16, int ldr, const float* a,
                         int lda, const float* b, int ldb, int m, int nt,
                         int k, int passes, void* stream) {
  if (m < 1 || nt < 1 || k < 1 || (passes != 1 && passes != 3))
    return cudaErrorInvalidValue;
  Args args{r, a, b, ldr, lda, ldb, m, nt, k,
            (m + kBM - 1) / kBM, (nt + kBN - 1) / kBN};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (passes == 3)
    return r_bf16 ? launch_aligned<true, __nv_bfloat16>(args, s)
                  : launch_aligned<true, float>(args, s);
  return r_bf16 ? launch_aligned<false, __nv_bfloat16>(args, s)
                : launch_aligned<false, float>(args, s);
}

}  // extern "C"
