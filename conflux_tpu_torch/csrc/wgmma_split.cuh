// The split-operand wgmma mainloop for R -/+ A @ B on f32 operands (K3,
// schur_update.cu; K2 is to move onto it): a pass that splits A and B into
// bf16 hi/lo copies, then a warp-specialised, persistent wgmma product of
// them fed by TMA. The building blocks are wgmma_tile.cuh's.
//
//   * Split pass (split_hi_lo_kernel): x ~= hi + lo with hi = bf16_rn(x),
//     lo = bf16_rn(x - hi), the round-to-nearest-even split of
//     conflux_tpu/ops/pallas_gemm._split_hi_lo and of the port's
//     ops/tri._split_hi_lo, bit for bit; lo only for 'high'. The copies'
//     row strides are padded to 16 bytes, so TMA takes them whatever the
//     callers' strides and offsets. The JAX package splits outside its
//     Pallas kernel too.
//   * Product: a [kBM, kBN] = [128, 256] output tile per step of a
//     persistent CTA, tiles in groups of kGroupM row tiles for L2 reuse.
//     Warpgroup 0 is the producer (one thread issues TMA loads into a ring
//     of stages, each with a full and an empty mbarrier); warpgroups 1 and
//     2 are consumers, each on 64 rows with wgmma m64n256k16 and 128 fp32
//     accumulators a thread. A stage holds one K chunk of 64: A_hi [128][64]
//     and B_hi as four [64 k][64 n] boxes (48 KB, 4 stages) in the one-pass
//     modes; A_hi, A_lo, B_hi, B_lo (96 KB, 2 stages) in 'high', where each
//     k16 step issues hi*hi + hi*lo + lo*hi into ONE accumulator (lo*lo
//     dropped, as XLA's Precision.HIGH drops it). Ragged edges read as zero
//     (TMA fills them), so the mainloop has no masks.

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

// the split copies' row stride in elements: a multiple of 8 (16 bytes)
inline int padded(int cols) { return (cols + 7) / 8 * 8; }

// rows x cols of f32 x (row stride ldx) into bf16 hi (and lo unless null),
// row stride lds; blockIdx.z picks A (0) or B (1)
struct SplitArgs {
  const float* x[2];
  int ldx[2], rows[2], cols[2], lds[2];
  __nv_bfloat16* hi[2];
  __nv_bfloat16* lo[2];
};

__global__ void __launch_bounds__(256) split_hi_lo_kernel(SplitArgs a) {
  const int z = blockIdx.z;
  const float* x = a.x[z];
  __nv_bfloat16* hi = a.hi[z];
  __nv_bfloat16* lo = a.lo[z];
  for (int r = blockIdx.y; r < a.rows[z]; r += gridDim.y) {
    const float* xr = x + (size_t)r * a.ldx[z];
    const size_t o = (size_t)r * a.lds[z];
    for (int c = blockIdx.x * blockDim.x + threadIdx.x; c < a.cols[z];
         c += gridDim.x * blockDim.x) {
      const float v = xr[c];
      const __nv_bfloat16 h = __float2bfloat16_rn(v);
      hi[o + c] = h;
      if (lo != nullptr)
        lo[o + c] = __float2bfloat16_rn(__fsub_rn(v, __bfloat162float(h)));
    }
  }
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

// producer (one thread): the nk K chunks of the tile at (row0, col0)
template <bool kX3>
__device__ __forceinline__ void produce(const Maps& maps, uint8_t* ring,
                                        uint64_t* full, uint64_t* empty,
                                        Pos& pos, int row0, int col0,
                                        int nk) {
  using R = Ring<kX3>;
  for (int kc = 0; kc < nk; ++kc) {
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

}  // namespace conflux_split
