// The split-operand wgmma mainloop for R - A @ B on f32 operands, shared
// by K3 (schur_update.cu, in place) and K2 (bigk_gemm.cu, into a fresh
// output, K split across CTAs where tiles are few): a pass that splits A
// and B into bf16 hi/lo copies, then a warp-specialised, persistent wgmma
// product of them fed by TMA, then an epilogue that subtracts from R once
// and rounds once. The building blocks are wgmma_tile.cuh's.
//
//   * Split pass (split_hi_lo_kernel): x ~= hi + lo with hi = bf16_rn(x),
//     lo = bf16_rn(x - hi), the round-to-nearest-even split of
//     conflux_tpu/ops/pallas_gemm._split_hi_lo and of the port's
//     ops/tri._split_hi_lo, bit for bit; lo only for 'high'. Groups of
//     four columns, four groups in flight a thread (16-byte loads where the
//     source rows allow). The copies' row
//     strides are padded to 16 bytes, so TMA takes them whatever the
//     callers' strides and offsets. The JAX package splits outside its
//     Pallas kernel too.
//   * Product: a [kBM, kBN] = [128, 256] output tile per work unit of a
//     persistent CTA, tiles in groups of kGroupM row tiles for L2 reuse; a
//     unit covers the K chunks [kc0, kc0 + nk) of its tile. Warpgroup 0 is
//     the producer (one thread issues TMA loads into a ring of stages, each
//     with a full and an empty mbarrier); warpgroups 1 and 2 are consumers,
//     each on 64 rows with wgmma m64n256k16 and 128 fp32 accumulators a
//     thread. A stage holds one K chunk of 64: A_hi [128][64] and B_hi as
//     four [64 k][64 n] boxes (48 KB, 4 stages) in the one-pass modes;
//     A_hi, A_lo, B_hi, B_lo (96 KB, 2 stages) in 'high', where each k16
//     step issues hi*hi + hi*lo + lo*hi into ONE accumulator (lo*lo
//     dropped, as XLA's Precision.HIGH drops it). Ragged edges read as zero
//     (TMA fills them), so the mainloop has no masks. Producer and
//     consumers walk the same units and carry one ring position (Pos)
//     across them, so the mbarrier phases stay in step whatever each
//     unit's nk.
//   * Epilogue (store_block): each consumer's [64, 256] block leaves the
//     registers a quarter (64 columns) at a time, o = R - acc (R read once
//     into registers, the first quarter during the mainloop) or o = acc,
//     rounded once into the output's type, through 128-byte-swizzled
//     staging and TMA stores that drain while the next unit computes, or,
//     where the output breaks TMA's 16-byte rules, straight from the
//     registers, masked.

#pragma once

#include <cuda_bf16.h>

#include "wgmma_tile.cuh"

namespace conflux_split {

using namespace conflux_wgmma;

constexpr int kBM = 128, kBN = 256, kBK = 64;
constexpr int kConsumers = 2;
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kGroupM = 8;                          // row tiles per group
constexpr int kABytes = kBM * kBK * 2;              // 16 KB
constexpr int kBBoxBytes = kBK * 64 * 2;            // 8 KB
constexpr int kBBytes = (kBN / 64) * kBBoxBytes;    // 32 KB
// A's stride between 8-row groups; B's between 64-column boxes and 8-row k
// groups (wgmma_tile.cuh)
constexpr uint32_t kASbo = 1024, kBLbo = kBBoxBytes, kBSbo = 1024;

template <bool kX3>
struct Ring {
  static constexpr int kStageBytes = (kX3 ? 2 : 1) * (kABytes + kBBytes);
  static constexpr int kStages = kX3 ? 2 : 4;
  static constexpr int kBytes = kStages * kStageBytes;
  // offsets inside a stage
  static constexpr int kAHi = 0, kBHi = kABytes;
  static constexpr int kALo = kABytes + kBBytes, kBLo = 2 * kABytes + kBBytes;
};
static_assert(Ring<true>::kStageBytes % 1024 == 0 &&
                  Ring<false>::kStageBytes % 1024 == 0,
              "stages stay 1024-byte aligned");

// per consumer: a quarter (64 columns) of its [64, 256] block in the
// epilogue, f32 as two [64][32] boxes or bf16 as one [64][64] box, each row
// 128 bytes
constexpr int kCStageBytes = 16384;
constexpr int kCBoxBytes = 8192;

// dynamic shared memory of one CTA of the product: the ring, the consumers'
// epilogue staging, the barriers
template <bool kX3>
constexpr size_t smem_bytes() {
  return (size_t)Ring<kX3>::kBytes + kConsumers * kCStageBytes +
         2 * Ring<kX3>::kStages * sizeof(uint64_t) + 1024;  // alignment slack
}

// ------------------------------------------------------------------- host

// the split copies' row stride in elements: a multiple of 8 (16 bytes)
inline int padded(int cols) { return (cols + 7) / 8 * 8; }

inline size_t align256(size_t b) { return (b + 255) / 256 * 256; }

// the workspace's split copies: A hi/lo [m, padded(k)], B hi/lo
// [k, padded(nt)] bf16, each 256-byte aligned
struct Layout {
  size_t a_bytes, b_bytes;
  int copies;                         // 2 (hi, lo) in 'high', else 1
  size_t total() const { return copies * (a_bytes + b_bytes); }
};

inline Layout layout(int m, int nt, int k, int passes) {
  return {align256((size_t)m * padded(k) * 2),
          align256((size_t)k * padded(nt) * 2), passes == 3 ? 2 : 1};
}

inline int sm_count() {
  int sms = 132, dev = 0;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

// rows x cols of f32 x (row stride ldx) into bf16 hi (and lo unless null),
// row stride lds, for A (0) and B (1); vec: x's rows start 16-byte
// aligned (16-byte loads)
struct SplitArgs {
  const float* x[2];
  int ldx[2], rows[2], cols[2], lds[2];
  bool vec[2];
  __nv_bfloat16* hi[2];
  __nv_bfloat16* lo[2];
};

// ----------------------------------------------------------------- device

__device__ __forceinline__ void split1(float v, __nv_bfloat16* hi,
                                       __nv_bfloat16* lo) {
  const __nv_bfloat16 h = __float2bfloat16_rn(v);
  *hi = h;
  if (lo != nullptr)
    *lo = __float2bfloat16_rn(__fsub_rn(v, __bfloat162float(h)));
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

constexpr int kSplitUnroll = 4;     // quads in flight a thread

// blockIdx.y picks A (0) or B (1); each thread takes kSplitUnroll quads
// (four consecutive columns of a row) a step, gridDim.x * blockDim.x
// apart, all loads first
__global__ void __launch_bounds__(256) split_hi_lo_kernel(SplitArgs a) {
  const int z = blockIdx.y;
  const float* x = a.x[z];
  __nv_bfloat16* hi = a.hi[z];
  __nv_bfloat16* lo = a.lo[z];
  const int cols = a.cols[z], ldx = a.ldx[z], lds = a.lds[z];
  const bool vec = a.vec[z];
  const int qpr = (cols + 3) / 4;                      // quads a row
  const long long nq = (long long)a.rows[z] * qpr;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i0 = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i0 < nq; i0 += kSplitUnroll * stride) {
    float4 v[kSplitUnroll];
    int row[kSplitUnroll], col[kSplitUnroll];
#pragma unroll
    for (int u = 0; u < kSplitUnroll; ++u) {
      const long long i = i0 + u * stride;
      if (nq <= 0xffffffffLL) {       // 32-bit division where it fits
        const uint32_t j = static_cast<uint32_t>(i);
        row[u] = static_cast<int>(j / static_cast<uint32_t>(qpr));
        col[u] = 4 * static_cast<int>(j % static_cast<uint32_t>(qpr));
      } else {
        row[u] = static_cast<int>(i / qpr);
        col[u] = 4 * static_cast<int>(i % qpr);
      }
      if (vec && i < nq && col[u] + 4 <= cols)
        v[u] = *reinterpret_cast<const float4*>(x + (size_t)row[u] * ldx +
                                                col[u]);
    }
#pragma unroll
    for (int u = 0; u < kSplitUnroll; ++u) {
      if (i0 + u * stride >= nq) break;
      const size_t o = (size_t)row[u] * lds + col[u];
      if (vec && col[u] + 4 <= cols) {
        // one 16-byte load, 8-byte stores (lds and col are multiples of 4)
        const __nv_bfloat162 h01 = __floats2bfloat162_rn(v[u].x, v[u].y);
        const __nv_bfloat162 h23 = __floats2bfloat162_rn(v[u].z, v[u].w);
        *reinterpret_cast<uint2*>(hi + o) =
            make_uint2(as_u32(h01), as_u32(h23));
        if (lo != nullptr)
          *reinterpret_cast<uint2*>(lo + o) = make_uint2(
              as_u32(__floats2bfloat162_rn(
                  __fsub_rn(v[u].x, __low2float(h01)),
                  __fsub_rn(v[u].y, __high2float(h01)))),
              as_u32(__floats2bfloat162_rn(
                  __fsub_rn(v[u].z, __low2float(h23)),
                  __fsub_rn(v[u].w, __high2float(h23)))));
      } else {
        const float* xr = x + (size_t)row[u] * ldx;
        for (int e = 0; e < 4 && col[u] + e < cols; ++e)
          split1(xr[col[u] + e], hi + o + e, lo ? lo + o + e : nullptr);
      }
    }
  }
}

// The same split of operand z of a whose source is stored transposed:
// element (r, c) at x[c * ldx + r] (a column-major [rows, cols] view, such
// as Cholesky's F[k:k+w, :k].T). 32 x 32 tiles pass through shared memory
// so that the reads run along r and the writes along c, both coalesced;
// blockDim (32, 8).
__global__ void __launch_bounds__(256) split_hi_lo_t_kernel(SplitArgs a,
                                                            int z) {
  __shared__ float tile[32][33];
  const float* x = a.x[z];
  __nv_bfloat16* hi = a.hi[z];
  __nv_bfloat16* lo = a.lo[z];
  const int rows = a.rows[z], cols = a.cols[z], ldx = a.ldx[z];
  const int lds = a.lds[z];
  const int tiles_r = (rows + 31) / 32;
  const long long tiles = (long long)tiles_r * ((cols + 31) / 32);
  const int tx = threadIdx.x, ty = threadIdx.y;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int r0 = static_cast<int>(t % tiles_r) * 32;
    const int c0 = static_cast<int>(t / tiles_r) * 32;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = r0 + tx, c = c0 + ty + 8 * i;
      tile[ty + 8 * i][tx] =
          r < rows && c < cols ? x[(size_t)c * ldx + r] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = r0 + ty + 8 * i, c = c0 + tx;
      if (r < rows && c < cols) {
        const size_t o = (size_t)r * lds + c;
        split1(tile[tx][ty + 8 * i], hi + o, lo ? lo + o : nullptr);
      }
    }
    __syncthreads();
  }
}

// the split pass's grid for up to `quads` quads of A or B: enough blocks
// for the card's memory, none idle at small sizes
inline dim3 split_grid(long long quads, int operands) {
  const long long want = (quads + 256LL * kSplitUnroll - 1) /
                         (256LL * kSplitUnroll);
  const long long most = 16LL * sm_count();
  return dim3(static_cast<unsigned>(want < most ? want : most), operands);
}

// tensor maps of the split copies: A [m, k] in [128][64] boxes, B [k, nt]
// in [64][64] boxes; lo maps only for 'high'
struct Maps {
  CUtensorMap a_hi, a_lo, b_hi, b_lo;
};

inline cudaError_t make_maps(Maps* maps, const SplitArgs& s, int m, int nt,
                             int k, bool x3) {
  const CUtensorMapDataType bf = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  cudaError_t e = make_map(&maps->a_hi, bf, 2, s.hi[0], m, k, s.lds[0], kBM,
                           kBK);
  if (e == cudaSuccess)
    e = make_map(&maps->b_hi, bf, 2, s.hi[1], k, nt, s.lds[1], kBK, 64);
  if (e == cudaSuccess && x3)
    e = make_map(&maps->a_lo, bf, 2, s.lo[0], m, k, s.lds[0], kBM, kBK);
  if (e == cudaSuccess && x3)
    e = make_map(&maps->b_lo, bf, 2, s.lo[1], k, nt, s.lds[1], kBK, 64);
  return e;
}

// The split pass of A [m, k] (row stride lda) and B [k, nt] (ldb; with
// b_trans, B is stored transposed: B[i, j] at b[j * ldb + i]) into the
// workspace ws (256-byte aligned, at least layout(m, nt, k, passes)
// .total() bytes) on `stream`, then the tensor maps of the copies. Returns
// 0 or a cudaError_t code (a refused launch included).
inline cudaError_t split_operands(Maps* maps, void* ws, const float* a,
                                  int lda, const float* b, int ldb,
                                  bool b_trans, int m, int nt, int k,
                                  int passes, cudaStream_t stream) {
  const Layout lay = layout(m, nt, k, passes);
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
  for (int z = 0; z < 2; ++z)
    sp.vec[z] = reinterpret_cast<uintptr_t>(sp.x[z]) % 16 == 0 &&
                sp.ldx[z] % 4 == 0;
  sp.hi[0] = reinterpret_cast<__nv_bfloat16*>(w);
  sp.hi[1] = reinterpret_cast<__nv_bfloat16*>(w + lay.a_bytes);
  sp.lo[0] = x3 ? reinterpret_cast<__nv_bfloat16*>(w + lay.a_bytes +
                                                   lay.b_bytes)
                : nullptr;
  sp.lo[1] = x3 ? reinterpret_cast<__nv_bfloat16*>(w + 2 * lay.a_bytes +
                                                   lay.b_bytes)
                : nullptr;
  const long long qa = (long long)m * ((k + 3) / 4);
  const long long qb = (long long)k * ((nt + 3) / 4);
  cudaError_t e;
  if (b_trans) {
    split_hi_lo_kernel<<<split_grid(qa, 1), 256, 0, stream>>>(sp);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    const long long tiles = (long long)((k + 31) / 32) * ((nt + 31) / 32);
    const long long most = 16LL * sm_count();
    split_hi_lo_t_kernel<<<static_cast<unsigned>(tiles < most ? tiles : most),
                           dim3(32, 8), 0, stream>>>(sp, 1);
  } else {
    split_hi_lo_kernel<<<split_grid(qa > qb ? qa : qb, 2), 256, 0, stream>>>(
        sp);
  }
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return make_maps(maps, sp, m, nt, k, x3);
}

// the t-th output tile in grouped order
__device__ __forceinline__ void tile_origin(int t, int tiles_m, int tiles_n,
                                            int& row0, int& col0) {
  const int per_group = kGroupM * tiles_n;
  const int first_m = (t / per_group) * kGroupM;
  const int group_m = min(tiles_m - first_m, kGroupM);
  row0 = (first_m + (t % per_group) % group_m) * kBM;
  col0 = ((t % per_group) / group_m) * kBN;
}

// ring position, the same sequence in the producer and each consumer
struct Pos {
  int stage = 0;
  uint32_t phase = 0;
  template <int kStages>
  __device__ __forceinline__ void next() {
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1;
    }
  }
};

// producer (one thread): K chunks kc0 .. kc0 + nk - 1 of the tile at
// (row0, col0)
template <bool kX3>
__device__ __forceinline__ void produce(const Maps& maps, uint8_t* ring,
                                        uint64_t* full, uint64_t* empty,
                                        Pos& pos, int row0, int col0,
                                        int kc0, int nk) {
  using R = Ring<kX3>;
  for (int kc = kc0; kc < kc0 + nk; ++kc) {
    mbar_wait(&empty[pos.stage], pos.phase ^ 1);
    uint8_t* st = ring + pos.stage * R::kStageBytes;
    uint64_t* bar = &full[pos.stage];
    mbar_expect_tx(bar, R::kStageBytes);
    tma_load_2d(st + R::kAHi, &maps.a_hi, bar, kc * kBK, row0);
    if (kX3) tma_load_2d(st + R::kALo, &maps.a_lo, bar, kc * kBK, row0);
#pragma unroll
    for (int j = 0; j < kBN / 64; ++j) {
      tma_load_2d(st + R::kBHi + j * kBBoxBytes, &maps.b_hi, bar,
                  col0 + 64 * j, kc * kBK);
      if (kX3)
        tma_load_2d(st + R::kBLo + j * kBBoxBytes, &maps.b_lo, bar,
                    col0 + 64 * j, kc * kBK);
    }
    pos.next<R::kStages>();
  }
}
// consumer warpgroup cw (its 64 rows of the tile): acc = the tile's
// A @ B over nk K chunks, releasing each stage once its wgmmas are done
template <bool kX3>
__device__ __forceinline__ void consume(float (&acc)[128], uint8_t* ring,
                                        uint64_t* full, uint64_t* empty,
                                        Pos& pos, int cw, int tid, int nk) {
  using R = Ring<kX3>;
  int prev = -1;
  for (int kc = 0; kc < nk; ++kc) {
    mbar_wait(&full[pos.stage], pos.phase);
    const uint8_t* st = ring + pos.stage * R::kStageBytes;
    const uint8_t* ahi = st + R::kAHi + cw * 64 * 128;
    const uint8_t* alo = st + R::kALo + cw * 64 * 128;
    const uint8_t* bhi = st + R::kBHi;
    const uint8_t* blo = st + R::kBLo;
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < kBK / 16; ++s) {
      const uint64_t dah = smem_desc(ahi + 32 * s, 16, kASbo);
      const uint64_t dbh = smem_desc(bhi + 2048 * s, kBLbo, kBSbo);
      wgmma_m64n256k16_bf16_tb(acc, dah, dbh, kc > 0 || s > 0);
      if (kX3) {
        wgmma_m64n256k16_bf16_tb(acc, dah,
                                 smem_desc(blo + 2048 * s, kBLbo, kBSbo), 1);
        wgmma_m64n256k16_bf16_tb(acc, smem_desc(alo + 32 * s, 16, kASbo),
                                 dbh, 1);
      }
    }
    wgmma_commit();
    wgmma_wait<1>();          // chunk kc - 1's products are done
    if (prev >= 0 && tid == 0) mbar_arrive(&empty[prev]);
    prev = pos.stage;
    pos.next<R::kStages>();
  }
  wgmma_wait<0>();
  if (prev >= 0 && tid == 0) mbar_arrive(&empty[prev]);
#pragma unroll
  for (int i = 0; i < 128; ++i) fence_operand(acc[i]);
}


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

// this thread's row and column in consumer cw's block of the tile at
// (row0, col0): its accumulator rows are gr0 and gr0 + 8, its columns
// gc0 + 8 j and gc0 + 8 j + 1
__device__ __forceinline__ void block_origin(int row0, int col0, int cw,
                                             int& gr0, int& gc0) {
  const int tid = threadIdx.x % 128;
  const int lane = tid % 32;
  gr0 = row0 + 64 * cw + 16 * (tid / 32) + lane / 4;
  gc0 = col0 + 2 * (lane % 4);
}

// The epilogue of consumer cw's [64, 256] block of the tile at (row0,
// col0): o = R - acc with kSub (cur holds R's quarter 0, loaded before the
// mainloop by load_quarter; the next quarter is read while the current one
// is written), o = acc without (r and cur unread); each element rounded
// once into T. With tma, through the consumer's 128-byte-swizzled staging
// cs and TMA stores of `map` (boxes [64][128 bytes]) at (col0 + 64 q,
// orow + row0 + 64 cw); otherwise from the registers into o (row stride
// ldo; float2/bf16x2 pairs where vec2o), masked to [0, m) x [0, nt).
// Leaves the last TMA store in flight: the kernel waits for it
// (bulk_wait_all) before it ends.
template <bool kSub, typename T>
__device__ __forceinline__ void store_block(
    const float (&acc)[128], float (&cur)[32], const T* r, int ldr,
    bool vec2r, T* o, int ldo, bool vec2o, const CUtensorMap* map, bool tma,
    int orow, int m, int nt, int row0, int col0, int cw, uint8_t* cs) {
  constexpr bool kF32 = sizeof(T) == 4;
  const int tid = threadIdx.x % 128;
  const int lane = tid % 32;
  const int rl = 16 * (tid / 32) + lane / 4;   // row in the consumer's block
  int gr0, gc0;
  block_origin(row0, col0, cw, gr0, gc0);
  float nxt[32];
#pragma unroll
  for (int q = 0; q < kBN / 64; ++q) {
    if (kSub && q + 1 < kBN / 64)
      load_quarter(r, ldr, m, nt, gr0, gc0, q + 1, vec2r, nxt);
#pragma unroll
    for (int i = 0; i < 32; ++i)
      cur[i] = kSub ? __fsub_rn(cur[i], acc[32 * q + i]) : acc[32 * q + i];
    if (tma) {
      // registers -> the swizzled staging -> TMA store; row rl + 8 h has
      // (rl + 8 h) % 8 == lane / 4, so a 16-byte chunk c lands at c ^ (lane / 4)
      if (tid == 0) bulk_wait_read<0>();     // the staging is free
      named_sync(1 + cw, 128);
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float x0 = cur[4 * jj + 2 * h], x1 = cur[4 * jj + 2 * h + 1];
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
        const int r0 = orow + row0 + 64 * cw;
        tma_store_2d(map, cs, col0 + 64 * q, r0);
        if (kF32) tma_store_2d(map, cs + kCBoxBytes, col0 + 64 * q + 32, r0);
        bulk_commit();
      }
    } else {
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int gr = gr0 + 8 * h, gc = gc0 + 64 * q + 8 * jj;
          if (gr >= m || gc >= nt) continue;
          T* p = o + (size_t)gr * ldo + gc;
          const float x0 = cur[4 * jj + 2 * h], x1 = cur[4 * jj + 2 * h + 1];
          if (vec2o && gc + 1 < nt) {
            st2(p, x0, x1);
          } else {
            st1(p, x0);
            if (gc + 1 < nt) st1(p + 1, x1);
          }
        }
    }
    if (kSub && q + 1 < kBN / 64)
#pragma unroll
      for (int i = 0; i < 32; ++i) cur[i] = nxt[i];
  }
}

}  // namespace conflux_split
