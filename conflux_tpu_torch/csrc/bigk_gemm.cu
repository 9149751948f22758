// K2 and K4, by hand for Hopper (sm_90a).
//
// K2: out = R - A @ B for a large K (the crout LU's panel update
// R[:, k:k+w] - R[:, :k] @ F[:k, k:k+w] and its pivot-row refresh).
// Replaces the TPU kernel conflux_tpu/ops/pallas_gemm.py:
// sub_matmul_pallas_bigk (kernels _acc_bigk_kernel and _acc_bigk_kernel_x3).
// Same arithmetic as K3 (schur_update.cu): R [m, nt] f32 (bf16 in mode
// 'bf16out'), A [m, k] and B [k, nt] f32, each operand element split into
// bf16 hi/lo in registers, 'high' = hi*hi + hi*lo + lo*hi, the one-pass
// modes hi*hi, fp32 sums; then out = round(float(R) - acc) into R's type,
// once, into a fresh tensor (R is read, never written).
//
// What bounds it on the H100: the tensor cores. At the crout path's shapes
// (k from 1536 to 30720, w = 1536) it does 2k (x3 in 'high') bf16 FLOPs per
// output element against 8 bytes of R and out traffic. The TPU kernel runs
// K as a sequential grid axis with a VMEM accumulator; on Hopper blocks run
// in no order, so K is the loop inside the block: the mainloop of
// mma_tile.cuh (the cp.async ring of f32 chunks, the split at fragment
// load, mma.sync), over a [256, 128] output tile per CTA, one CTA per SM
// (173 KB of shared memory). That leaves the late crout steps short of
// tiles: at k = 30720 the panel update's output is [2048, 1536], 96 tiles
// on 132 SMs, each a 30720-long K loop, and the pivot-row refresh
// [1536, 512] is 24 tiles. So when a call has fewer tiles than
// kWaves x SMs, K splits across blocks (split-K): each split accumulates
// its own K range (whole chunks, at least kMinSplitChunks of them) into an
// fp32 workspace [splits, m, nt] that the caller allocates, and a second
// kernel sums the slices in split order (fixed, so the result does not
// change from run to run), subtracts once from R and rounds once. At
// k = 30720 that is 6 splits of the panel update (576 CTAs) and 22 of the
// refresh (528 CTAs). The first crout steps have enough tiles (1464 at
// k = 1536) and run without a workspace.
//
// K4: C = A @ B with an fp32 result, the plain GEMM skeleton. Replaces
// conflux_tpu/ops/pallas_gemm.py:matmul_pallas (kernel _mm_kernel). A and B
// are both float32 or both bfloat16:
//   * float32: IEEE fp32 products and sums (fmaf), no tensor cores. (Mosaic
//     ran an f32 x f32 jnp.dot as one bf16 pass on TPU silicon; the JAX
//     tests check the interpret-mode fp32 function, and TF32 would be a
//     third function.) Bound by the card's 67 TFLOP/s of fp32 FMA: a
//     [128, 128] tile per 256-thread CTA, 8 x 8 outputs per thread read as
//     float4 pairs 64 apart (conflict-free), A stored transposed in shared
//     memory, K in chunks of 8, double-buffered through registers;
//   * bfloat16: mma.sync m16n8k16 with fp32 accumulation (products of bf16
//     values are exact in fp32): a [128, 128] tile per CTA of 8 warps, each
//     a [32, 64] sub-tile, K in chunks of 32 bf16, double-buffered through
//     registers (16-byte loads where the rows are 16-byte aligned).
// Both take any shape and any row stride; the ragged edges read as zero
// and the stores are masked. wgmma and TMA are later work.

#include "mma_tile.cuh"

namespace {

using namespace conflux_mma;

constexpr int kWaves = 4;            // split K below this many waves of CTAs
constexpr int kMinSplitChunks = 16;  // K chunks per split, at least

struct Plan {
  int tiles_m, tiles_n, splits, k_per_split;
};

Plan plan(int m, int nt, int k) {
  Plan p;
  p.tiles_m = (m + kBM - 1) / kBM;
  p.tiles_n = (nt + kBN - 1) / kBN;
  const long long tiles = (long long)p.tiles_m * p.tiles_n;
  const int chunks = (k + kBK - 1) / kBK;
  int sms = 132, dev = 0;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long target = (long long)kWaves * sms;
  long long splits = 1;
  if (tiles < target) {
    splits = (target + tiles - 1) / tiles;
    splits = splits < chunks / kMinSplitChunks ? splits
                                               : chunks / kMinSplitChunks;
    if (splits < 1) splits = 1;
  }
  const int per = (chunks + (int)splits - 1) / (int)splits;
  p.k_per_split = per * kBK;
  p.splits = (chunks + per - 1) / per;     // no split is left empty
  return p;
}

long long workspace_floats(const Plan& p, int m, int nt) {
  return p.splits > 1 ? (long long)p.splits * m * nt : 0;
}

struct BigkArgs {
  const void* r;    // R [m, nt], row stride ldr
  void* out;        // out [m, nt], row stride ldo
  float* ws;        // [splits, m, nt] partial products when splits > 1
  int ldr, ldo;
  Operands op;
  int tiles_m, tiles_n, k_per_split;
};

template <bool kX3, bool kVec, typename T>
__global__ void __launch_bounds__(kThreads) sub_matmul_bigk_kernel(
    BigkArgs a) {
  extern __shared__ __align__(128) float smem[];
  int row0, col0;
  tile_origin(blockIdx.x, a.tiles_m, a.tiles_n, row0, col0);
  const int kb = blockIdx.y * a.k_per_split;
  Operands op = a.op;
  op.k = min(op.k, kb + a.k_per_split);
  Acc acc;
  mainloop<kX3, kVec>(op, smem, row0, col0, kb, acc);

  float* cs = smem;
  stage_acc(acc, cs);
  const bool split = gridDim.y > 1;
  const T* r = static_cast<const T*>(a.r);
  T* out = static_cast<T*>(a.out);
  for (int idx = threadIdx.x; idx < kBM * kBN; idx += kThreads) {
    const int i = idx / kBN, j = idx % kBN;
    const int gr = row0 + i, gc = col0 + j;
    if (gr < op.m && gc < op.nt) {
      const float c = cs[i * kLdC + j];
      if (split)
        a.ws[((size_t)blockIdx.y * op.m + gr) * op.nt + gc] = c;
      else
        store_r(out + (size_t)gr * a.ldo + gc,
                __fsub_rn(load_r(r + (size_t)gr * a.ldr + gc), c));
    }
  }
}

// out = R - (ws[0] + ws[1] + ... + ws[splits-1]), summed in split order
template <typename T>
__global__ void __launch_bounds__(256) bigk_reduce_kernel(
    const T* r, int ldr, T* out, int ldo, const float* ws, int m, int nt,
    int splits) {
  const size_t plane = (size_t)m * nt;
  for (size_t idx = blockIdx.x * (size_t)blockDim.x + threadIdx.x;
       idx < plane; idx += (size_t)gridDim.x * blockDim.x) {
    const int i = static_cast<int>(idx / nt), j = static_cast<int>(idx % nt);
    float s = ws[idx];
    for (int p = 1; p < splits; ++p) s = __fadd_rn(s, ws[p * plane + idx]);
    store_r(out + (size_t)i * ldo + j,
            __fsub_rn(load_r(r + (size_t)i * ldr + j), s));
  }
}

template <bool kX3, bool kVec, typename T>
cudaError_t launch_bigk(const BigkArgs& args, const Plan& p,
                        cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      sub_matmul_bigk_kernel<kX3, kVec, T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBytes));
  if (e != cudaSuccess) return e;
  const long long tiles = (long long)p.tiles_m * p.tiles_n;
  if (tiles > 0x7fffffffLL || p.splits > 65535) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(tiles), p.splits);
  sub_matmul_bigk_kernel<kX3, kVec, T>
      <<<grid, kThreads, kSmemBytes, stream>>>(args);
  e = cudaGetLastError();
  if (e != cudaSuccess || p.splits == 1) return e;
  const long long plane = (long long)args.op.m * args.op.nt;
  int sms = 132, dev = 0;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  long long blocks = (plane + 255) / 256;
  if (blocks > 8LL * sms) blocks = 8LL * sms;
  bigk_reduce_kernel<T><<<static_cast<unsigned>(blocks), 256, 0, stream>>>(
      static_cast<const T*>(args.r), args.ldr, static_cast<T*>(args.out),
      args.ldo, args.ws, args.op.m, args.op.nt, p.splits);
  return cudaGetLastError();
}

template <bool kX3, typename T>
cudaError_t launch_bigk_aligned(const BigkArgs& args, const Plan& p,
                                cudaStream_t stream) {
  return operands_16b_aligned(args.op)
             ? launch_bigk<kX3, true, T>(args, p, stream)
             : launch_bigk<kX3, false, T>(args, p, stream);
}

// ---------------------------------------------------------------- K4 f32

constexpr int kF32BM = 128, kF32BN = 128, kF32BK = 8, kF32Threads = 256;

template <bool kVec>
__global__ void __launch_bounds__(kF32Threads) matmul_f32_kernel(
    const float* a, int lda, const float* b, int ldb, float* c, int ldc,
    int m, int n, int k) {
  __shared__ __align__(16) float sa[2][kF32BK][kF32BM];  // A chunk, [k][m]
  __shared__ __align__(16) float sb[2][kF32BK][kF32BN];  // B chunk, [k][n]
  const int row0 = blockIdx.y * kF32BM, col0 = blockIdx.x * kF32BN;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  // this thread's share of each chunk: 4 A elements of one row, 4 B
  // elements of one K row
  const int ar = tid / 2, ac = 4 * (tid % 2);
  const int br = tid / 32, bc = 4 * (tid % 32);
  float ra[4], rb[4];

  auto fetch = [&](int k0) {
    const int gr = row0 + ar, gk = k0 + ac;
    if (kVec && gr < m && gk + 4 <= k) {
      const float4 v =
          *reinterpret_cast<const float4*>(a + (size_t)gr * lda + gk);
      ra[0] = v.x; ra[1] = v.y; ra[2] = v.z; ra[3] = v.w;
    } else {
#pragma unroll
      for (int u = 0; u < 4; ++u)
        ra[u] = gr < m && gk + u < k ? a[(size_t)gr * lda + gk + u] : 0.f;
    }
    const int bk = k0 + br, gc = col0 + bc;
    if (kVec && bk < k && gc + 4 <= n) {
      const float4 v =
          *reinterpret_cast<const float4*>(b + (size_t)bk * ldb + gc);
      rb[0] = v.x; rb[1] = v.y; rb[2] = v.z; rb[3] = v.w;
    } else {
#pragma unroll
      for (int u = 0; u < 4; ++u)
        rb[u] = bk < k && gc + u < n ? b[(size_t)bk * ldb + gc + u] : 0.f;
    }
  };
  auto put = [&](int s) {
#pragma unroll
    for (int u = 0; u < 4; ++u) sa[s][ac + u][ar] = ra[u];
    *reinterpret_cast<float4*>(&sb[s][br][bc]) =
        make_float4(rb[0], rb[1], rb[2], rb[3]);
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const int nk = (k + kF32BK - 1) / kF32BK;
  fetch(0);
  put(0);
  __syncthreads();
  for (int kc = 0; kc < nk; ++kc) {
    const int s = kc & 1;
    if (kc + 1 < nk) fetch((kc + 1) * kF32BK);   // in flight during the FMAs
#pragma unroll
    for (int kk = 0; kk < kF32BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&sa[s][kk][4 * ty]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&sa[s][kk][4 * ty + 64]);
      const float4 b0 = *reinterpret_cast<const float4*>(&sb[s][kk][4 * tx]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&sb[s][kk][4 * tx + 64]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    if (kc + 1 < nk) put(s ^ 1);  // stage s^1 was last read before the
    __syncthreads();              // previous barrier
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gr = row0 + (i < 4 ? 4 * ty + i : 64 + 4 * ty + i - 4);
    if (gr >= m) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gc = col0 + 4 * tx + 64 * h;
      float* p = c + (size_t)gr * ldc + gc;
      if (kVec && gc + 4 <= n) {
        *reinterpret_cast<float4*>(p) =
            make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                        acc[i][4 * h + 3]);
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (gc + u < n) p[u] = acc[i][4 * h + u];
      }
    }
  }
}

// --------------------------------------------------------------- K4 bf16

constexpr int kHBM = 128, kHBN = 128, kHBK = 32, kHThreads = 256;
constexpr int kHWarpsN = 2, kHWM = 32, kHWN = 64;
constexpr int kHMT = kHWM / 16, kHNT = kHWN / 8;
constexpr int kHLdA = kHBK + 8;     // bf16 elements; 80-byte rows
constexpr int kHLdB = kHBN + 8;     // 272-byte rows
static_assert((kHBM / kHWM) * kHWarpsN * 32 == kHThreads, "warp layout");

// bf16 elements [r, c .. c+8) of a [rows, cols] matrix as one uint4, zero
// past the edges
template <bool kVec>
__device__ __forceinline__ uint4 load8(const uint16_t* base, int ld, int r,
                                       int c, int rows, int cols) {
  if (r >= rows || c >= cols) return make_uint4(0, 0, 0, 0);
  const uint16_t* p = base + (size_t)r * ld + c;
  if (kVec && c + 8 <= cols) return *reinterpret_cast<const uint4*>(p);
  uint32_t w[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const uint32_t lo = c + 2 * u < cols ? p[2 * u] : 0;
    const uint32_t hi = c + 2 * u + 1 < cols ? p[2 * u + 1] : 0;
    w[u] = lo | (hi << 16);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

template <bool kVec>
__global__ void __launch_bounds__(kHThreads) matmul_bf16_kernel(
    const uint16_t* a, int lda, const uint16_t* b, int ldb, float* c,
    int ldc, int m, int n, int k) {
  __shared__ __align__(16) uint16_t sa[2][kHBM * kHLdA];
  __shared__ __align__(16) uint16_t sb[2][kHBK * kHLdB];
  const int row0 = blockIdx.y * kHBM, col0 = blockIdx.x * kHBN;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int wr = (warp / kHWarpsN) * kHWM, wc = (warp % kHWarpsN) * kHWN;
  const int g = lane >> 2, q = lane & 3;
  uint4 ra[2], rb[2];

  auto fetch = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int seg = tid + i * kHThreads;
      ra[i] = load8<kVec>(a, lda, row0 + seg / 4, k0 + 8 * (seg % 4), m, k);
      rb[i] = load8<kVec>(b, ldb, k0 + seg / 16, col0 + 8 * (seg % 16), k, n);
    }
  };
  auto put = [&](int s) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int seg = tid + i * kHThreads;
      *reinterpret_cast<uint4*>(&sa[s][(seg / 4) * kHLdA + 8 * (seg % 4)]) =
          ra[i];
      *reinterpret_cast<uint4*>(&sb[s][(seg / 16) * kHLdB + 8 * (seg % 16)]) =
          rb[i];
    }
  };

  float acc[kHMT][kHNT][4];
#pragma unroll
  for (int i = 0; i < kHMT; ++i)
#pragma unroll
    for (int j = 0; j < kHNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int nk = (k + kHBK - 1) / kHBK;
  fetch(0);
  put(0);
  __syncthreads();
  for (int kc = 0; kc < nk; ++kc) {
    const int s = kc & 1;
    if (kc + 1 < nk) fetch((kc + 1) * kHBK);
    const uint16_t* xa = sa[s];
    const uint16_t* xb = sb[s];
#pragma unroll
    for (int kk = 0; kk < kHBK; kk += 16) {
      uint32_t af[kHMT][4], bf[kHNT][2];
#pragma unroll
      for (int i = 0; i < kHMT; ++i) {
        const uint16_t* p = xa + (wr + 16 * i + g) * kHLdA + kk + 2 * q;
        af[i][0] = *reinterpret_cast<const uint32_t*>(p);
        af[i][1] = *reinterpret_cast<const uint32_t*>(p + 8 * kHLdA);
        af[i][2] = *reinterpret_cast<const uint32_t*>(p + 8);
        af[i][3] = *reinterpret_cast<const uint32_t*>(p + 8 * kHLdA + 8);
      }
#pragma unroll
      for (int j = 0; j < kHNT; ++j) {
        const uint16_t* p = xb + (kk + 2 * q) * kHLdB + wc + 8 * j + g;
        bf[j][0] = (uint32_t)p[0] | ((uint32_t)p[kHLdB] << 16);
        bf[j][1] = (uint32_t)p[8 * kHLdB] | ((uint32_t)p[9 * kHLdB] << 16);
      }
#pragma unroll
      for (int i = 0; i < kHMT; ++i)
#pragma unroll
        for (int j = 0; j < kHNT; ++j) mma_bf16(acc[i][j], af[i], bf[j]);
    }
    if (kc + 1 < nk) put(s ^ 1);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kHMT; ++i)
#pragma unroll
    for (int j = 0; j < kHNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int gr = row0 + wr + 16 * i + g + (e >= 2 ? 8 : 0);
        const int gc = col0 + wc + 8 * j + 2 * q + (e & 1);
        if (gr < m && gc < n) c[(size_t)gr * ldc + gc] = acc[i][j][e];
      }
}

}  // namespace

extern "C" {

const char* conflux_bigk_gemm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// dynamic shared memory a K2 CTA uses (ptxas reports static memory only)
int conflux_sub_matmul_bigk_smem_bytes() {
  return static_cast<int>(kSmemBytes);
}

// K2's K splits for an [m, nt] output and depth k on the current device
int conflux_sub_matmul_bigk_splits(int m, int nt, int k) {
  return plan(m, nt, k).splits;
}

// floats of fp32 workspace K2 needs for that call (0 without split-K)
long long conflux_sub_matmul_bigk_workspace_floats(int m, int nt, int k) {
  return workspace_floats(plan(m, nt, k), m, nt);
}

// out = R - A @ B on `stream`. r_bf16: R and out are bfloat16 (mode
// 'bf16out'), else float32. passes: 3 for 'high', 1 for 'bf16'/'bf16out'.
// ws holds ws_floats floats, at least conflux_sub_matmul_bigk_workspace_
// floats(m, nt, k). Returns 0 or a cudaError_t code (a refused launch
// included); never synchronises.
int conflux_sub_matmul_bigk(const void* r, int ldr, void* out, int ldo,
                            int r_bf16, const float* a, int lda,
                            const float* b, int ldb, int m, int nt, int k,
                            int passes, float* ws, long long ws_floats,
                            void* stream) {
  if (m < 1 || nt < 1 || k < 1 || (passes != 1 && passes != 3))
    return cudaErrorInvalidValue;
  const Plan p = plan(m, nt, k);
  if (ws_floats < workspace_floats(p, m, nt)) return cudaErrorInvalidValue;
  BigkArgs args{r, out, ws, ldr, ldo, Operands{a, b, lda, ldb, m, nt, k},
                p.tiles_m, p.tiles_n, p.k_per_split};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (passes == 3)
    return r_bf16 ? launch_bigk_aligned<true, __nv_bfloat16>(args, p, s)
                  : launch_bigk_aligned<true, float>(args, p, s);
  return r_bf16 ? launch_bigk_aligned<false, __nv_bfloat16>(args, p, s)
                : launch_bigk_aligned<false, float>(args, p, s);
}

// C = A @ B on `stream`, C [m, n] float32 with row stride ldc; A [m, k]
// and B [k, n] both float32 (bf16 == 0) or both bfloat16 (bf16 == 1).
// Returns 0 or a cudaError_t code; never synchronises.
int conflux_matmul(const void* a, int lda, const void* b, int ldb, float* c,
                   int ldc, int m, int n, int k, int bf16, void* stream) {
  if (m < 1 || n < 1 || k < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uintptr_t pa = reinterpret_cast<uintptr_t>(a);
  const uintptr_t pb = reinterpret_cast<uintptr_t>(b);
  const uintptr_t pc = reinterpret_cast<uintptr_t>(c);
  if (bf16) {
    const long long gm = (m + kHBM - 1) / kHBM, gn = (n + kHBN - 1) / kHBN;
    if (gm > 65535 || gn > 0x7fffffffLL) return cudaErrorInvalidValue;
    const dim3 grid(static_cast<unsigned>(gn), static_cast<unsigned>(gm));
    const bool vec = pa % 16 == 0 && pb % 16 == 0 && lda % 8 == 0 &&
                     ldb % 8 == 0;
    const uint16_t* ua = static_cast<const uint16_t*>(a);
    const uint16_t* ub = static_cast<const uint16_t*>(b);
    if (vec)
      matmul_bf16_kernel<true><<<grid, kHThreads, 0, s>>>(ua, lda, ub, ldb,
                                                          c, ldc, m, n, k);
    else
      matmul_bf16_kernel<false><<<grid, kHThreads, 0, s>>>(ua, lda, ub, ldb,
                                                           c, ldc, m, n, k);
    return cudaGetLastError();
  }
  const long long gm = (m + kF32BM - 1) / kF32BM;
  const long long gn = (n + kF32BN - 1) / kF32BN;
  if (gm > 65535 || gn > 0x7fffffffLL) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(gn), static_cast<unsigned>(gm));
  const bool vec = pa % 16 == 0 && pb % 16 == 0 && pc % 16 == 0 &&
                   lda % 4 == 0 && ldb % 4 == 0 && ldc % 4 == 0;
  const float* fa = static_cast<const float*>(a);
  const float* fb = static_cast<const float*>(b);
  if (vec)
    matmul_f32_kernel<true><<<grid, kF32Threads, 0, s>>>(fa, lda, fb, ldb, c,
                                                         ldc, m, n, k);
  else
    matmul_f32_kernel<false><<<grid, kF32Threads, 0, s>>>(fa, lda, fb, ldb,
                                                          c, ldc, m, n, k);
  return cudaGetLastError();
}

}  // extern "C"
