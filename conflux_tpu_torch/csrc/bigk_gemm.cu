// K2 and K4, by hand for Hopper (sm_90a).
//
// K2: out = R - A @ B for a large K (the crout LU's panel update
// R[:, k:k+w] - R[:, :k] @ F[:k, k:k+w] and its pivot-row refresh).
// Replaces the TPU kernel conflux_tpu/ops/pallas_gemm.py:
// sub_matmul_pallas_bigk (kernels _acc_bigk_kernel and _acc_bigk_kernel_x3).
// Same arithmetic as K3 (schur_update.cu): R [m, nt] f32 (bf16 in mode
// 'bf16out'), A [m, k] and B [k, nt] f32 (B may be stored transposed, as
// the Cholesky panel update's F[k:k+w, :k].T: the split pass reads it in
// place through shared-memory tiles), each operand element split into
// bf16 hi = bf16_rn(x) and lo = bf16_rn(x - hi), 'high' = hi*hi + hi*lo +
// lo*hi, the one-pass modes hi*hi, fp32 sums; then out = round(float(R) -
// acc) into R's type, once, into a fresh tensor (R is read, never written).
//
// What bounds it on the H100: the tensor cores. At the crout path's shapes
// (k from 1536 to 30720, w = 1536) it does 2k (x3 in 'high') bf16 FLOPs per
// output element against 8 bytes of R and out traffic, and only wgmma
// reaches the tensor cores' rate. The design is K3's (wgmma_split.cuh):
//   * a split pass writes bf16 hi (and, in 'high', lo) copies of A and B
//     into the workspace the caller allocates, with row strides padded to
//     16 bytes, so every call takes the one TMA-fed route. Each f32
//     operand element is read once and split once, where a CTA that split
//     in registers re-split A for every column tile. The pass is the cost
//     of that: at the path's largest calls it moves ~2.1 GB (A [17408,
//     15360] at the panel update of step k = 15360, 'high': ~0.64 ms at
//     the card's memory rate) and ~2 GB (B [15360, 15872] at the refresh
//     of that step, ~0.58 ms), against a product bound of ~2.5 ms; in the
//     one-pass modes it is the same cast the plain version does;
//   * the product is the warp-specialised, persistent TMA + wgmma mainloop
//     ([128, 256] tiles, 4 x 48 KB stages, 2 x 96 KB in 'high' with one
//     accumulator for its three products), over work units (tile, split);
//   * the late crout steps are short of tiles (the panel update at k =
//     30720 is [2048, 1536], 96 tiles on 132 SMs, each a 30720-long K; its
//     pivot-row refresh [1536, 512] is 24), so below kWaves waves of tiles
//     K splits across units (split-K: whole chunks of 64, at least
//     kMinSplitChunks per split, none empty; 6 splits of that panel update,
//     22 of that refresh). One persistent grid walks all units, split-major;
//   * an unsplit unit runs K3's epilogue: R's elements read once into
//     registers (the first quarter during the mainloop), out = R - acc
//     rounded once, written by TMA stores through swizzled staging, or from
//     the registers where out's width breaks TMA's 16-byte rules (a TMA
//     box clipped at an unaligned last column writes into the columns
//     past it). A split unit writes its fp32 partial product into its own
//     plane of the workspace (tile-padded, so TMA stores never cross
//     planes), and a second kernel sums the planes in split order (fixed,
//     so the result does not change from run to run), subtracts once from
//     R and rounds once.
//
// K2 also takes bfloat16 A and B (the crout LU's and Cholesky's panel
// updates under bf16 storage, whose operands are already bf16) in 'bf16'
// and 'bf16out': conflux_sub_matmul_bigk_bf16 builds the tensor maps on the
// caller's operands (a transposed B on its stored rows, K-major) and runs
// kernels of its own, wgmma_bf16.cuh: ping-pong consumers on [128, 128]
// tiles whose epilogue (R staged by TMA, subtracted, TMA-stored) runs
// under the other consumer's products, with split-K summed inside the
// kernel by each tile's last split; for long K on many tiles, cooperative
// [128, 256] tiles. Its route (ping-pong tiles with the TMA epilogue or
// from the registers, ping-pong split-K, cooperative tiles) and B's
// layout are reported to the caller.
//
// K4: C = A @ B with an fp32 result, the plain GEMM skeleton. Replaces
// conflux_tpu/ops/pallas_gemm.py:matmul_pallas (kernel _mm_kernel). A and B
// are both float32 or both bfloat16:
//   * float32: IEEE fp32 products and sums (fmaf, in K order), no tensor
//     cores. (Mosaic ran an f32 x f32 jnp.dot as one bf16 pass on TPU
//     silicon; the JAX tests check the interpret-mode fp32 function, and
//     TF32 would be a third function.) Bound by the card's 67 TFLOP/s of
//     fp32 FMA: a [128, 256] tile per 256-thread CTA, fed by a 3-stage
//     cp.async ring of K chunks of 32 (one barrier per 32 K steps, no
//     register staging);
//   * bfloat16 (products of bf16 values are exact in fp32, sums in fp32):
//     bound by the tensor cores (989 TFLOP/s) at large shapes, by writing
//     the fp32 C where K is short. Operands TMA can take (16-byte-aligned
//     base, row stride a multiple of 8) go to a warp-specialised kernel:
//     TMA loads into a 4-stage ring of 128-byte-swizzled shared memory
//     with mbarriers, two consumer warpgroups on wgmma m64n256k16,
//     persistent CTAs whose epilogue overlaps the next tile's loads
//     (wgmma_tile.cuh holds the building blocks). Other operands go to
//     mma.sync m16n8k16 on register-staged tiles. The route depends on
//     the operands' alignment alone and is reported to the caller.
// All take any shape and any row stride; the ragged edges read as zero
// (TMA fills them) and the stores are masked.

#include <algorithm>

#include "wgmma_bf16.cuh"
#include "wgmma_split.cuh"

namespace {

using namespace conflux_split;

// ---------------------------------------------------------------- K2

constexpr int kWaves = 4;            // split K below this many waves of tiles
constexpr int kMinSplitChunks = 16;  // K chunks per split, at least

struct Plan {
  int tiles_m, tiles_n, chunks, splits, per;    // per: K chunks a split
};

Plan plan(int m, int nt, int k) {
  Plan p;
  p.tiles_m = (m + kBM - 1) / kBM;
  p.tiles_n = (nt + kBN - 1) / kBN;
  p.chunks = (k + kBK - 1) / kBK;
  const long long tiles = (long long)p.tiles_m * p.tiles_n;
  const long long target = (long long)kWaves * sm_count();
  long long splits = 1;
  if (tiles < target) {
    splits = (target + tiles - 1) / tiles;
    splits = std::min<long long>(splits, p.chunks / kMinSplitChunks);
    if (splits < 1) splits = 1;
  }
  p.per = (p.chunks + (int)splits - 1) / (int)splits;
  p.splits = (p.chunks + p.per - 1) / p.per;     // no split is left empty
  return p;
}

// split-K's planes, after the split copies in the workspace: splits x
// [tiles_m * kBM, plane_ld(nt)] fp32 partial products, each plane padded
// to whole tiles and its rows to 16 bytes
int plane_ld(int nt) { return (nt + 3) / 4 * 4; }
size_t plane_rows(const Plan& p) { return (size_t)p.tiles_m * kBM; }

size_t workspace_bytes(const Plan& p, int m, int nt, int k, int passes) {
  const size_t planes =
      p.splits > 1 ? (size_t)p.splits * plane_rows(p) * plane_ld(nt) * 4 : 0;
  return layout(m, nt, k, passes).total() + planes;
}

enum BigkRoute { kBigkRouteWgmma = 1 };

// kSplit: every unit writes its partial product into its plane (r and out
// unused); otherwise out = R - A @ B (planes unused)
template <bool kX3, bool kSplit, typename T>
__global__ void __launch_bounds__(kThreads, 1) sub_matmul_bigk_kernel(
    const __grid_constant__ Maps maps,
    const __grid_constant__ CUtensorMap map_o, bool tma_o, const T* r,
    int ldr, T* out, int ldo, float* planes, int ldw, int m, int nt,
    Plan p) {
  using Rg = Ring<kX3>;
  extern __shared__ uint8_t k2_smem_raw[];
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(k2_smem_raw) + 1023) & ~uintptr_t(1023));
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
  // work unit u: tile u % tiles, K chunks [kc0, kc0 + nk) of split u / tiles
  const int tiles = p.tiles_m * p.tiles_n;
  const int units = tiles * p.splits;
  const int wg = threadIdx.x / 128;

  if (wg == 0) {
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      Pos pos;
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        int row0, col0;
        tile_origin(u % tiles, p.tiles_m, p.tiles_n, row0, col0);
        const int kc0 = (u / tiles) * p.per;
        produce<kX3>(maps, ring, full, empty, pos, row0, col0, kc0,
                     min(p.per, p.chunks - kc0));
      }
    }
    return;
  }

  setmaxnreg_inc<232>();
  const int cw = wg - 1;                       // this consumer's 64 rows
  const int tid = threadIdx.x % 128;
  const bool vec2r = ldr % 2 == 0 &&
                     reinterpret_cast<uintptr_t>(r) % (2 * sizeof(T)) == 0;
  const bool vec2o = ldo % 2 == 0 &&
                     reinterpret_cast<uintptr_t>(out) % (2 * sizeof(T)) == 0;
  uint8_t* cs = cstage + cw * kCStageBytes;
  float acc[128];
  Pos pos;
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    int row0, col0;
    tile_origin(u % tiles, p.tiles_m, p.tiles_n, row0, col0);
    const int split = u / tiles;
    const int nk = min(p.per, p.chunks - split * p.per);
    float cur[32];
    if constexpr (kSplit) {
      consume<kX3>(acc, ring, full, empty, pos, cw, tid, nk);
      // this split's partial product, into its plane
      const int prow = split * p.tiles_m * kBM;
      store_block<false>(acc, cur, r, 0, false, planes + (size_t)prow * ldw,
                         ldw, true, &map_o, tma_o, prow, m, nt, row0, col0,
                         cw, cs);
    } else {
      int gr0, gc0;
      block_origin(row0, col0, cw, gr0, gc0);
      // R's first quarter is in flight during the mainloop
      load_quarter(r, ldr, m, nt, gr0, gc0, 0, vec2r, cur);
      consume<kX3>(acc, ring, full, empty, pos, cw, tid, nk);
      store_block<true>(acc, cur, r, ldr, vec2r, out, ldo, vec2o, &map_o,
                        tma_o, 0, m, nt, row0, col0, cw, cs);
    }
  }
  if (tid == 0) bulk_wait_all();     // the TMA stores are done
}

// out = R - (ws[0] + ws[1] + ... + ws[splits-1]), summed in split order;
// plane p's row i at ws + p * plane + i * ldw
template <typename T>
__global__ void __launch_bounds__(256) bigk_reduce_kernel(
    const T* r, int ldr, T* out, int ldo, const float* ws, int ldw,
    size_t plane, int m, int nt, int splits) {
  const size_t n = (size_t)m * nt;
  for (size_t idx = blockIdx.x * (size_t)blockDim.x + threadIdx.x; idx < n;
       idx += (size_t)gridDim.x * blockDim.x) {
    const int i = static_cast<int>(idx / nt), j = static_cast<int>(idx % nt);
    const float* w = ws + (size_t)i * ldw + j;
    float s = w[0];
    for (int q = 1; q < splits; ++q) s = __fadd_rn(s, w[q * plane]);
    st1(out + (size_t)i * ldo + j,
        __fsub_rn(ld1(r + (size_t)i * ldr + j), s));
  }
}

// one launch of the product kernel over all units of plan p
template <bool kX3, bool kSplit, typename T>
cudaError_t start_bigk(const Maps& maps, const CUtensorMap& map_o,
                       bool tma_o, const T* r, int ldr, T* out, int ldo,
                       float* planes, int m, int nt, const Plan& p,
                       cudaStream_t stream) {
  auto kernel = sub_matmul_bigk_kernel<kX3, kSplit, T>;
  const size_t smem = smem_bytes<kX3>();
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const long long units = (long long)p.tiles_m * p.tiles_n * p.splits;
  if (units > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int sms = sm_count();
  const int grid = static_cast<int>(units < sms ? units : sms);
  kernel<<<grid, kThreads, smem, stream>>>(maps, map_o, tma_o, r, ldr, out,
                                           ldo, planes, plane_ld(nt), m, nt,
                                           p);
  return cudaGetLastError();
}

template <bool kX3, typename T>
cudaError_t launch_bigk(const Maps& maps, const T* r, int ldr, T* out,
                        int ldo, float* planes, int m, int nt, const Plan& p,
                        cudaStream_t stream) {
  const int ldw = plane_ld(nt);
  CUtensorMap map_o{};
  if (p.splits > 1) {
    // the planes, one map over all of them: [splits * plane_rows, ldw];
    // the split units write fp32 partials whatever R's type
    cudaError_t e =
        make_map(&map_o, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, planes,
                 (uint64_t)p.splits * plane_rows(p), ldw, ldw, 64, 32);
    if (e == cudaSuccess)
      e = start_bigk<kX3, true, float>(maps, map_o, true, nullptr, 0,
                                       nullptr, 0, planes, m, nt, p, stream);
    if (e != cudaSuccess) return e;
    const long long n = (long long)m * nt;
    const long long blocks =
        std::min<long long>((n + 255) / 256, 8LL * sm_count());
    bigk_reduce_kernel<T><<<static_cast<unsigned>(blocks), 256, 0, stream>>>(
        r, ldr, out, ldo, planes, ldw, plane_rows(p) * ldw, m, nt, p.splits);
    return cudaGetLastError();
  }
  // TMA stores clip a box at out's last column only to 16 bytes, so out's
  // width must be a multiple of 16 bytes too
  const bool tma_o = reinterpret_cast<uintptr_t>(out) % 16 == 0 &&
                     ((size_t)ldo * sizeof(T)) % 16 == 0 &&
                     ((size_t)nt * sizeof(T)) % 16 == 0 && ldo >= nt;
  if (tma_o) {
    const cudaError_t e = make_map(
        &map_o,
        sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                       : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
        sizeof(T), out, m, nt, ldo, 64, 128 / sizeof(T));
    if (e != cudaSuccess) return e;
  }
  return start_bigk<kX3, false, T>(maps, map_o, tma_o, r, ldr, out, ldo,
                                   nullptr, m, nt, p, stream);
}

// ----------------------------------------------- K2 on bf16 operands

namespace b16 = conflux_bf16;

// split K only under this many waves of super-tiles, each split at least
// kBf16MinSplitChunks chunks; a split costs about kBf16SplitCost chunk
// times (its partial plane written, then read by the tile's last split)
constexpr int kBf16Waves = 2;
constexpr int kBf16MinSplitChunks = 16;
constexpr int kBf16SplitCost = 3;

// the clusters of the bf16 kernel the card runs at once (one CTA an SM)
int bf16_clusters();

// The units of an [m, nt] output at depth k: whole super-tiles, or, under
// kBf16Waves waves of them, the split count with the least estimated time
// (the busiest cluster's chunks plus the splits' cost). A cluster's units
// run one after another (its consumers take turns on the tensor cores).
b16::Plan plan_bf16(int m, int nt, int k) {
  b16::Plan p;
  p.super_m = (m + b16::kCM * b16::kTM - 1) / (b16::kCM * b16::kTM);
  p.super_n = (nt + b16::kCN * b16::kTN - 1) / (b16::kCN * b16::kTN);
  p.chunks = (k + b16::kTK - 1) / b16::kTK;
  p.splits = 1;
  p.per = p.chunks;
  const long long supers = (long long)p.super_m * p.super_n;
  const long long clusters = bf16_clusters();
  if (clusters < 1 || supers >= kBf16Waves * clusters) return p;
  long long best = (supers + clusters - 1) / clusters * p.chunks;
  for (int s = 2; s <= p.chunks / kBf16MinSplitChunks; ++s) {
    const int per = (p.chunks + s - 1) / s;
    const int used = (p.chunks + per - 1) / per;   // none left empty
    const long long cost = (supers * used + clusters - 1) / clusters * per +
                           kBf16SplitCost * used;
    if (cost < best) {
      best = cost;
      p.splits = used;
      p.per = per;
    }
  }
  return p;
}

// tiles of the grid padded to whole super-tiles: the split-K counters
int bf16_tiles(const b16::Plan& p) {
  return p.super_m * b16::kCM * p.super_n * b16::kCN;
}

// the bf16 entry's routes (reported through its int* route): the kind,
// plus kBf16BKMajor where B was read transposed in place
enum Bf16Route {
  kBf16TilesTma = 1,        // ping-pong tiles, R and out through TMA
  kBf16TilesRegisters = 2,  // ping-pong tiles, R and out from the registers
  kBf16SplitK = 3,          // ping-pong split-K, summed by each tile's last
  kBf16Coop = 4,            // cooperative [128, 256] tiles
  kBf16BKMajor = 8,
};

// The cooperative route takes long K on many tiles: more than
// kBf16PingpongChunks chunks (where the mainloop outweighs the epilogue
// the ping-pong route hides) and at least kBf16Waves waves of its tiles
// (fewer go to the ping-pong route's finer tiles and split-K)
constexpr int kBf16PingpongChunks = 32;

b16::CoPlan plan_coop(int m, int nt, int k) {
  const int tiles_m = (m + b16::kTM - 1) / b16::kTM;
  return {(tiles_m + b16::kCoCM - 1) / b16::kCoCM,
          (nt + b16::kCoBN - 1) / b16::kCoBN, (k + b16::kTK - 1) / b16::kTK};
}

bool use_coop(int m, int nt, int k) {
  if (plan_bf16(m, nt, k).splits > 1) return false;
  const b16::CoPlan c = plan_coop(m, nt, k);
  return c.chunks > kBf16PingpongChunks &&
         (long long)c.super_m * b16::kCoCM * c.tiles_n >=
             (long long)kBf16Waves * sm_count();
}

size_t bf16_planes_bytes(const b16::Plan& p) {
  return p.splits > 1 ? (size_t)bf16_tiles(p) * p.splits * b16::kTileElems *
                            sizeof(float)
                      : 0;
}

// a launch of a bf16 kernel in `clusters` clusters of `size` CTAs
cudaLaunchConfig_t bf16_config(int clusters, int size, size_t smem,
                               cudaStream_t s, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(clusters * size));
  cfg.blockDim = dim3(b16::kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = size;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// the clusters of `size` CTAs of `kernel` (smem bytes a CTA) the card
// runs at once; 0 if it cannot tell
template <typename K>
int max_clusters(K kernel, int size, size_t smem) {
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem)) != cudaSuccess)
    return 0;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      bf16_config(sm_count() / size, size, smem, nullptr, &attr);
  int clusters = 0;
  if (cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg) != cudaSuccess)
    return 0;
  return clusters;
}

int bf16_clusters() {
  static const int n = max_clusters(
      b16::sub_matmul_bf16_kernel<float, false, b16::kEpiTma>, b16::kCluster,
      b16::Cfg<b16::kEpiTma>::kSmem);
  return n;
}

int bf16_coop_clusters() {
  static const int n =
      max_clusters(b16::sub_matmul_bf16_coop_kernel<float, false>,
                   b16::kCoCM, b16::kCoSmem);
  return n;
}

template <typename T, bool kBT>
cudaError_t start_coop(const CUtensorMap& map_a, const CUtensorMap& map_b,
                       const CUtensorMap& map_o, bool tma_o, const T* r,
                       int ldr, T* out, int ldo, int m, int nt,
                       const b16::CoPlan& p, cudaStream_t stream) {
  auto kernel = b16::sub_matmul_bf16_coop_kernel<T, kBT>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(b16::kCoSmem));
  if (e != cudaSuccess) return e;
  const long long units = (long long)p.super_m * p.tiles_n;
  const int most = bf16_coop_clusters();
  if (units > 0x7fffffffLL || most < 1) return cudaErrorInvalidValue;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      bf16_config(static_cast<int>(units < most ? units : most), b16::kCoCM,
                  b16::kCoSmem, stream, &attr);
  const cudaError_t l = cudaLaunchKernelEx(&cfg, kernel, map_a, map_b, map_o,
                                           tma_o, r, ldr, out, ldo, m, nt, p);
  return l != cudaSuccess ? l : cudaGetLastError();
}

template <typename T, bool kBT, int kEpi>
cudaError_t start_bf16(const CUtensorMap& map_a, const CUtensorMap& map_b,
                       const CUtensorMap& map_r, const CUtensorMap& map_o,
                       const T* r, int ldr, T* out, int ldo, float* planes,
                       int* counters, int m, int nt, const b16::Plan& p,
                       cudaStream_t stream) {
  auto kernel = b16::sub_matmul_bf16_kernel<T, kBT, kEpi>;
  const size_t smem = b16::Cfg<kEpi>::kSmem;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const long long units = (long long)p.super_m * p.super_n * p.splits;
  const int most = bf16_clusters();
  if (units > 0x7fffffffLL || most < 1) return cudaErrorInvalidValue;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      bf16_config(static_cast<int>(units < most ? units : most),
                  b16::kCluster, smem, stream, &attr);
  const cudaError_t l = cudaLaunchKernelEx(&cfg, kernel, map_a, map_b, map_r,
                                           map_o, r, ldr, out, ldo, planes,
                                           counters, m, nt, p);
  return l != cudaSuccess ? l : cudaGetLastError();
}

template <typename T, bool kBT>
cudaError_t route_bf16(int kind, const CUtensorMap& map_a,
                       const CUtensorMap& map_b, const CUtensorMap& map_r,
                       const CUtensorMap& map_o, const T* r, int ldr, T* out,
                       int ldo, float* planes, int* counters, int m, int nt,
                       const b16::Plan& p, cudaStream_t s) {
  switch (kind) {
    case kBf16TilesTma:
      return start_bf16<T, kBT, b16::kEpiTma>(map_a, map_b, map_r, map_o, r,
                                               ldr, out, ldo, planes,
                                               counters, m, nt, p, s);
    case kBf16TilesRegisters:
      return start_bf16<T, kBT, b16::kEpiDirect>(map_a, map_b, map_r, map_o,
                                                  r, ldr, out, ldo, planes,
                                                  counters, m, nt, p, s);
    default:
      return start_bf16<T, kBT, b16::kEpiSplit>(map_a, map_b, map_r, map_o,
                                                 r, ldr, out, ldo, planes,
                                                 counters, m, nt, p, s);
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// the cooperative route: A in [128][64] boxes, B in [64 k][64 n] boxes
// (MN-major) or [256 n][64 k] ones (K-major)
template <typename T>
cudaError_t launch_coop(const T* r, int ldr, T* out, int ldo, const void* a,
                        int lda, const void* b, int ldb, bool b_kmajor, int m,
                        int nt, int k, cudaStream_t stream, int* route) {
  const CUtensorMapDataType bf = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap map_a, map_b, map_o{};
  cudaError_t e = make_map(&map_a, bf, 2, a, m, k, lda, b16::kTM, b16::kTK);
  if (e == cudaSuccess)
    e = b_kmajor ? make_map(&map_b, bf, 2, b, nt, k, ldb,
                            b16::kCoBN / b16::kCoCM, b16::kTK)
                 : make_map(&map_b, bf, 2, b, k, nt, ldb, b16::kTK, 64);
  // out through TMA stores where TMA takes it (a store box clipped at an
  // unaligned last column writes past it), else from the registers
  constexpr size_t kT = sizeof(T);
  const bool tma_o = aligned16(out) && ldo >= nt && (ldo * kT) % 16 == 0 &&
                     (nt * kT) % 16 == 0;
  if (e == cudaSuccess && tma_o)
    e = make_map(&map_o,
                 kT == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                         : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                 kT, out, m, nt, ldo, 64, 128 / kT);
  if (e != cudaSuccess) return e;
  *route = kBf16Coop + (b_kmajor ? kBf16BKMajor : 0);
  const b16::CoPlan p = plan_coop(m, nt, k);
  return b_kmajor ? start_coop<T, true>(map_a, map_b, map_o, tma_o, r, ldr,
                                        out, ldo, m, nt, p, stream)
                  : start_coop<T, false>(map_a, map_b, map_o, tma_o, r, ldr,
                                         out, ldo, m, nt, p, stream);
}

template <typename T>
cudaError_t launch_bf16(const T* r, int ldr, T* out, int ldo, const void* a,
                        int lda, const void* b, int ldb, bool b_kmajor, int m,
                        int nt, int k, void* ws, long long ws_bytes,
                        int* counters, int counter_slots,
                        cudaStream_t stream, int* route) {
  if (use_coop(m, nt, k))
    return launch_coop(r, ldr, out, ldo, a, lda, b, ldb, b_kmajor, m, nt, k,
                       stream, route);
  const b16::Plan p = plan_bf16(m, nt, k);
  const bool split = p.splits > 1;
  if (split && (ws_bytes < static_cast<long long>(bf16_planes_bytes(p)) ||
                reinterpret_cast<uintptr_t>(ws) % 256 != 0 ||
                counter_slots < bf16_tiles(p)))
    return cudaErrorInvalidValue;
  const CUtensorMapDataType bf = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap map_a, map_b, map_r{}, map_o{};
  // A in slices of kTM / kCN rows, a K-major B in slices of kTN / kCM
  // rows (each CTA of a cluster row or column loads one), an MN-major B
  // in [64 k][64 n] boxes
  cudaError_t e = make_map(&map_a, bf, 2, a, m, k, lda, b16::kTM / b16::kCN,
                           b16::kTK);
  if (e == cudaSuccess)
    e = b_kmajor ? make_map(&map_b, bf, 2, b, nt, k, ldb,
                            b16::kTN / b16::kCM, b16::kTK)
                 : make_map(&map_b, bf, 2, b, k, nt, ldb, b16::kTK, 64);
  // R and out through TMA where TMA takes both: 16-byte-aligned bases and
  // row strides, and out's width a multiple of 16 bytes (a store box
  // clipped at an unaligned last column writes past it)
  constexpr size_t kT = sizeof(T);
  const bool tma_io = aligned16(r) && aligned16(out) && ldr >= nt &&
                      ldo >= nt && (ldr * kT) % 16 == 0 &&
                      (ldo * kT) % 16 == 0 && (nt * kT) % 16 == 0;
  const int kind = split ? kBf16SplitK
                   : tma_io ? kBf16TilesTma
                            : kBf16TilesRegisters;
  const CUtensorMapDataType tt = kT == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                         : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  if (e == cudaSuccess && kind == kBf16TilesTma)
    e = make_map(&map_r, tt, kT, r, m, nt, ldr, b16::kTM, 128 / kT);
  if (e == cudaSuccess && kind == kBf16TilesTma)
    e = make_map(&map_o, tt, kT, out, m, nt, ldo, b16::kTM, 128 / kT);
  if (e != cudaSuccess) return e;
  *route = kind + (b_kmajor ? kBf16BKMajor : 0);
  float* planes = static_cast<float*>(ws);
  return b_kmajor ? route_bf16<T, true>(kind, map_a, map_b, map_r, map_o, r,
                                        ldr, out, ldo, planes, counters, m,
                                        nt, p, stream)
                  : route_bf16<T, false>(kind, map_a, map_b, map_r, map_o, r,
                                         ldr, out, ldo, planes, counters, m,
                                         nt, p, stream);
}

// ------------------------------------------------- cp.async and mma.sync

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

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// ---------------------------------------------------------------- K4 f32

// A [128, 256] tile per CTA of 256 threads, one CTA per SM (213 registers
// a thread); each thread owns 8 x 16 outputs (rows 4ty.. and 64 + 4ty..,
// columns 4tx + 64h.., h < 4), read per K step as float4s 64 apart
// (conflict-free). A kF32Stages-deep cp.async ring of K chunks of 32, one
// barrier per chunk: B lands row-major [32][256] (16-byte copies where
// aligned); A lands K-major [32][128 + 4] through 4-byte copies, each warp
// copying 8 K values of 4 rows (four full 32-byte sectors read, 32
// distinct banks written). Each thread's copy addresses are fixed but for
// K: four A row pointers and one B pointer, set up once. (A [128, 128]
// tile at two CTAs per SM ran 5 % slower on an H100.)
constexpr int kF32BM = 128, kF32BN = 256, kF32BK = 32, kF32Stages = 3;
constexpr int kF32Threads = 256;
constexpr int kF32ColGroups = kF32BN / 64;     // float4 column pairs
constexpr int kF32MinBlocks = 256 / kF32BN;    // CTAs per SM
constexpr int kF32LdA = kF32BM + 4;
constexpr int kF32StageA = kF32BK * kF32LdA;                 // floats
constexpr int kF32StageFloats = kF32StageA + kF32BK * kF32BN;
constexpr size_t kF32Smem = sizeof(float) * kF32Stages * kF32StageFloats;

// One thread's share of a chunk: A rows ra + 32i at K offsets ca + 8j
// (i, j < 4); B rows rb + kBVStep u at columns cb..cb+3 (vector copies)
// or rows rb + kBEStep u at column cb (element copies).
template <bool kVec>
struct F32Loader {
  static constexpr int kBVStep = kF32Threads / (kF32BN / 4);
  static constexpr int kBEStep = kF32Threads / kF32BN;
  const float* pa[4];    // A row pointers, null past m
  const float* pb;       // B at row 0 of this thread's rows, column cb
  size_t ldb;
  int ra, ca, rb, cb, bw;   // bw: B columns this thread copies (vector)
  const float* a0;
  const float* b0;
  int k;

  __device__ __forceinline__ F32Loader(const float* a, int lda,
                                       const float* b, int ldb_, int m,
                                       int n, int k_, int row0, int col0,
                                       int tid)
      : ldb(ldb_), a0(a), b0(b), k(k_) {
    const int lane = tid % 32, warp = tid / 32;
    ra = 4 * warp + lane / 8;
    ca = lane % 8;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int gr = row0 + ra + 32 * i;
      pa[i] = gr < m ? a + (size_t)gr * lda : nullptr;
    }
    if (kVec) {
      rb = tid / (kF32BN / 4);
      cb = 4 * (tid % (kF32BN / 4));
    } else {
      rb = tid / kF32BN;
      cb = tid % kF32BN;
    }
    const int gc = col0 + cb;
    bw = kVec ? max(0, min(4, n - gc)) : (gc < n ? 1 : 0);
    pb = b + gc;
  }

  // start the copies of K chunk [k0, k0 + kF32BK) into stage st
  __device__ __forceinline__ void load(float* st, int k0) const {
    float* sa = st + ca * kF32LdA + ra;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gk = k0 + ca + 8 * j;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bool in = pa[i] != nullptr && gk < k;
        cp_async4(sa + 8 * j * kF32LdA + 32 * i, in ? pa[i] + gk : a0,
                  in ? 4 : 0);
      }
    }
    float* sb = st + kF32StageA + rb * kF32BN + cb;
    if (kVec) {
#pragma unroll
      for (int u = 0; u < kF32BK / kBVStep; ++u) {
        const int gk = k0 + rb + kBVStep * u;
        const int w = gk < k ? bw : 0;
        cp_async16(sb + kBVStep * u * kF32BN, w ? pb + gk * ldb : b0, 4 * w);
      }
    } else {
#pragma unroll 4
      for (int u = 0; u < kF32BK / kBEStep; ++u) {
        const int gk = k0 + rb + kBEStep * u;
        const bool in = bw && gk < k;
        cp_async4(sb + kBEStep * u * kF32BN, in ? pb + gk * ldb : b0,
                  in ? 4 : 0);
      }
    }
  }
};

template <bool kVec>
__global__ void __launch_bounds__(kF32Threads, kF32MinBlocks)
matmul_f32_kernel(
    const float* a, int lda, const float* b, int ldb, float* c, int ldc,
    int m, int n, int k) {
  constexpr int kCols = 4 * kF32ColGroups;
  extern __shared__ __align__(16) float f32_smem[];
  const int row0 = blockIdx.y * kF32BM, col0 = blockIdx.x * kF32BN;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;

  float acc[8][kCols];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;

  const F32Loader<kVec> loader(a, lda, b, ldb, m, n, k, row0, col0, tid);
  const int nk = (k + kF32BK - 1) / kF32BK;
#pragma unroll
  for (int s = 0; s < kF32Stages - 1; ++s) {
    if (s < nk)
      loader.load(f32_smem + s * kF32StageFloats, s * kF32BK);
    cp_async_commit();
  }
  for (int kc = 0; kc < nk; ++kc) {
    cp_async_wait<kF32Stages - 2>();
    __syncthreads();     // chunk kc landed; every thread is done with kc - 1
    const int next = kc + kF32Stages - 1;
    if (next < nk)
      loader.load(f32_smem + (next % kF32Stages) * kF32StageFloats,
                  next * kF32BK);
    cp_async_commit();
    const float* sa = f32_smem + (kc % kF32Stages) * kF32StageFloats;
    const float* sb = sa + kF32StageA;
#pragma unroll 8
    for (int kk = 0; kk < kF32BK; ++kk) {
      const float* arow = sa + kk * kF32LdA;
      const float* brow = sb + kk * kF32BN;
      const float4 a0 = *reinterpret_cast<const float4*>(arow + 4 * ty);
      const float4 a1 = *reinterpret_cast<const float4*>(arow + 4 * ty + 64);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      float bv[kCols];
#pragma unroll
      for (int h = 0; h < kF32ColGroups; ++h) {
        const float4 bq =
            *reinterpret_cast<const float4*>(brow + 4 * tx + 64 * h);
        bv[4 * h] = bq.x;
        bv[4 * h + 1] = bq.y;
        bv[4 * h + 2] = bq.z;
        bv[4 * h + 3] = bq.w;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j)
          acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gr = row0 + (i < 4 ? 4 * ty + i : 64 + 4 * ty + i - 4);
    if (gr >= m) continue;
#pragma unroll
    for (int h = 0; h < kF32ColGroups; ++h) {
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

// ------------------------------------------------------ K4 bf16, mma.sync

// The route for operands TMA cannot take (a base off 16 bytes or a row
// stride not a multiple of 8 elements): a [128, 128] tile per CTA of 8
// warps on mma.sync m16n8k16, each warp a [32, 64] sub-tile, K in chunks
// of 32, double-buffered through registers with element loads.
constexpr int kHBM = 128, kHBN = 128, kHBK = 32, kHThreads = 256;
constexpr int kHWarpsN = 2, kHWM = 32, kHWN = 64;
constexpr int kHMT = kHWM / 16, kHNT = kHWN / 8;
constexpr int kHLdA = kHBK + 8;     // bf16 elements; 80-byte rows
constexpr int kHLdB = kHBN + 8;     // 272-byte rows
static_assert((kHBM / kHWM) * kHWarpsN * 32 == kHThreads, "warp layout");

// bf16 elements [r, c .. c+8) of a [rows, cols] matrix as one uint4, zero
// past the edges
__device__ __forceinline__ uint4 load8(const uint16_t* base, int ld, int r,
                                       int c, int rows, int cols) {
  if (r >= rows || c >= cols) return make_uint4(0, 0, 0, 0);
  const uint16_t* p = base + (size_t)r * ld + c;
  uint32_t w[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const uint32_t lo = c + 2 * u < cols ? p[2 * u] : 0;
    const uint32_t hi = c + 2 * u + 1 < cols ? p[2 * u + 1] : 0;
    w[u] = lo | (hi << 16);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

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
      ra[i] = load8(a, lda, row0 + seg / 4, k0 + 8 * (seg % 4), m, k);
      rb[i] = load8(b, ldb, k0 + seg / 16, col0 + 8 * (seg % 16), k, n);
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

// --------------------------------------------------- K4 bf16, wgmma + TMA

// Persistent CTAs, one per SM, walk [128, 256] output tiles in grouped
// order. Three warpgroups: warpgroup 0 is the producer (one thread issues
// the TMA loads, the others leave; its registers go to the consumers), 1
// and 2 are consumers, each running wgmma m64n256k16 on its 64 rows with
// 128 fp32 accumulators a thread. K moves in chunks of 64 through a ring of
// kWgStages stages (A [128][64] and B as four [64 k][64 n] boxes, 48 KB a
// stage), each with a full barrier (TMA bytes landed) and an empty barrier
// (both consumers done reading). A consumer keeps one chunk's wgmmas in
// flight and releases the stage before it. The producer loads the next
// tile's chunks during the epilogue. The epilogue goes through shared
// memory: each consumer writes a quarter of its fp32 block at a time into
// 128-byte-swizzled staging boxes (two lanes to a bank, the least a warp's
// 256 bytes allow) and one thread hands them to a TMA store, which drains
// to device memory while the next tile computes; where C's base or row
// stride does not suit TMA, the registers are stored directly, masked.
constexpr int kWgBM = 128, kWgBN = 256, kWgBK = 64, kWgStages = 4;
constexpr int kWgConsumers = 2;
constexpr int kWgThreads = 128 * (kWgConsumers + 1);
constexpr int kWgABytes = kWgBM * kWgBK * 2;           // 16 KB
constexpr int kWgBBoxBytes = kWgBK * 64 * 2;            // 8 KB
constexpr int kWgStageBytes = kWgABytes + (kWgBN / 64) * kWgBBoxBytes;
constexpr int kWgGroupM = 8;                            // row tiles per group
// A's stride between 8-row groups; B's between 64-column boxes and 8-row
// k groups (wgmma_tile.cuh)
constexpr uint32_t kWgASbo = 1024, kWgBLbo = kWgBBoxBytes, kWgBSbo = 1024;
// the epilogue: each consumer stages a quarter of its [64, 256] fp32 block
// (two [64][32] boxes, 128-byte swizzled) for one TMA store at a time
constexpr int kWgCBoxCols = 32;                         // 128-byte rows
constexpr int kWgCBoxBytes = 64 * kWgCBoxCols * 4;      // 8 KB
constexpr int kWgCStageBytes = 2 * kWgCBoxBytes;        // 16 KB
constexpr size_t kWgSmem =
    (size_t)kWgStages * kWgStageBytes + kWgConsumers * kWgCStageBytes +
    2 * kWgStages * sizeof(uint64_t) + 1024;            // alignment slack
static_assert(kWgStageBytes % 1024 == 0, "stages stay 1024-byte aligned");

__device__ __forceinline__ void wg_tile(int t, int tiles_m, int tiles_n,
                                        int& row0, int& col0) {
  const int per_group = kWgGroupM * tiles_n;
  const int first_m = (t / per_group) * kWgGroupM;
  const int group_m = min(tiles_m - first_m, kWgGroupM);
  row0 = (first_m + (t % per_group) % group_m) * kWgBM;
  col0 = ((t % per_group) / group_m) * kWgBN;
}

__global__ void __launch_bounds__(kWgThreads, 1) matmul_wgmma_kernel(
    const __grid_constant__ CUtensorMap map_a,
    const __grid_constant__ CUtensorMap map_b,
    const __grid_constant__ CUtensorMap map_c, bool tma_c, float* c,
    int ldc, int m, int n, int k, int tiles_m, int tiles_n) {
  using namespace conflux_wgmma;
  extern __shared__ uint8_t wg_smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(wg_smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* cstage = smem + kWgStages * kWgStageBytes;
  uint64_t* full =
      reinterpret_cast<uint64_t*>(cstage + kWgConsumers * kWgCStageBytes);
  uint64_t* empty = full + kWgStages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kWgStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kWgConsumers);
    }
    fence_barrier_init();
  }
  __syncthreads();
  const int tiles = tiles_m * tiles_n;
  const int nk = (k + kWgBK - 1) / kWgBK;
  const int wg = threadIdx.x / 128;

  if (wg == 0) {
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        int row0, col0;
        wg_tile(t, tiles_m, tiles_n, row0, col0);
        for (int kc = 0; kc < nk; ++kc) {
          mbar_wait(&empty[stage], phase ^ 1);
          uint8_t* st = smem + stage * kWgStageBytes;
          mbar_expect_tx(&full[stage], kWgStageBytes);
          tma_load_2d(st, &map_a, &full[stage], kc * kWgBK, row0);
#pragma unroll
          for (int j = 0; j < kWgBN / 64; ++j)
            tma_load_2d(st + kWgABytes + j * kWgBBoxBytes, &map_b,
                        &full[stage], col0 + 64 * j, kc * kWgBK);
          if (++stage == kWgStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    setmaxnreg_inc<232>();
    const int cw = wg - 1;                       // this consumer's 64 rows
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const bool vec2 = ldc % 2 == 0 && reinterpret_cast<uintptr_t>(c) % 8 == 0;
    float acc[128];
    int stage = 0;
    uint32_t phase = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      int row0, col0;
      wg_tile(t, tiles_m, tiles_n, row0, col0);
      int prev = -1;
      for (int kc = 0; kc < nk; ++kc) {
        mbar_wait(&full[stage], phase);
        const uint8_t* sa = smem + stage * kWgStageBytes + cw * 64 * 128;
        const uint8_t* sb = smem + stage * kWgStageBytes + kWgABytes;
        wgmma_fence();
#pragma unroll
        for (int s = 0; s < kWgBK / 16; ++s)
          wgmma_m64n256k16_bf16_tb(
              acc, smem_desc(sa + 32 * s, 16, kWgASbo),
              smem_desc(sb + 2048 * s, kWgBLbo, kWgBSbo), kc > 0 || s > 0);
        wgmma_commit();
        wgmma_wait<1>();          // chunk kc - 1's products are done
        if (prev >= 0 && tid == 0) mbar_arrive(&empty[prev]);
        prev = stage;
        if (++stage == kWgStages) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      if (tid == 0) mbar_arrive(&empty[prev]);
#pragma unroll
      for (int i = 0; i < 128; ++i) fence_operand(acc[i]);

      if (tma_c) {
        // a quarter (64 columns) at a time: registers -> the swizzled
        // staging boxes -> one TMA store of two boxes; each thread's row r
        // has r % 8 == lane / 4, its float2 at 16-byte chunk
        // (2 j' + (lane % 4) / 2) ^ (lane / 4) of the 128-byte box row
        uint8_t* cs = cstage + cw * kWgCStageBytes;
        const int r = 16 * warp + lane / 4;
#pragma unroll
        for (int q = 0; q < kWgBN / 64; ++q) {
          if (tid == 0) bulk_wait_read<0>();     // the staging is free
          named_sync(1 + cw, 128);
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) {
            const int j = 8 * q + jj;
            const int box = jj / 4, chunk = 2 * (jj % 4) + (lane % 4) / 2;
            uint8_t* p = cs + box * kWgCBoxBytes +
                         ((chunk ^ (lane / 4)) * 16) + 8 * (lane % 2);
#pragma unroll
            for (int h = 0; h < 2; ++h)
              *reinterpret_cast<float2*>(p + (r + 8 * h) * 128) =
                  make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
          }
          fence_proxy_async();     // the writes, visible to the TMA store
          named_sync(1 + cw, 128);
          if (tid == 0) {
            tma_store_2d(&map_c, cs, col0 + 64 * q, row0 + 64 * cw);
            tma_store_2d(&map_c, cs + kWgCBoxBytes,
                         col0 + 64 * q + kWgCBoxCols, row0 + 64 * cw);
            bulk_commit();
          }
        }
        continue;
      }
      const int r0 = row0 + 64 * cw + 16 * warp + lane / 4;
      const int cb = col0 + 2 * (lane % 4);
#pragma unroll
      for (int j = 0; j < kWgBN / 8; ++j) {
        const int gc = cb + 8 * j;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int gr = r0 + 8 * h;
          if (gr >= m || gc >= n) continue;
          float* p = c + (size_t)gr * ldc + gc;
          const float x0 = acc[4 * j + 2 * h], x1 = acc[4 * j + 2 * h + 1];
          if (vec2 && gc + 1 < n) {
            *reinterpret_cast<float2*>(p) = make_float2(x0, x1);
          } else {
            p[0] = x0;
            if (gc + 1 < n) p[1] = x1;
          }
        }
      }
    }
    if (tid == 0) bulk_wait_all();     // the TMA stores are done
  }
}

// K4's routes: f32 FMA, bf16 mma.sync, bf16 wgmma + TMA
enum MatmulRoute { kRouteF32 = 0, kRouteMmaSync = 1, kRouteWgmma = 2 };

// TMA takes a bf16 operand whose base is 16-byte aligned and whose row
// stride is a multiple of 8 elements and no shorter than its rows
bool tma_ok(const void* p, int ld, int cols) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && ld % 8 == 0 &&
         ld >= cols;
}

cudaError_t launch_wgmma(const void* a, int lda, const void* b, int ldb,
                         float* c, int ldc, int m, int n, int k,
                         cudaStream_t stream) {
  CUtensorMap map_a, map_b, map_c{};
  const CUtensorMapDataType bf = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  cudaError_t e = conflux_wgmma::make_map(&map_a, bf, 2, a, m, k, lda,
                                          kWgBM, kWgBK);
  if (e == cudaSuccess)
    e = conflux_wgmma::make_map(&map_b, bf, 2, b, k, n, ldb, kWgBK, 64);
  // C through TMA stores where TMA takes it, else from the registers
  const bool tma_c = reinterpret_cast<uintptr_t>(c) % 16 == 0 &&
                     ldc % 4 == 0 && ldc >= n;
  if (e == cudaSuccess && tma_c)
    e = conflux_wgmma::make_map(&map_c, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4,
                                c, m, n, ldc, 64, kWgCBoxCols);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(matmul_wgmma_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(kWgSmem));
  if (e != cudaSuccess) return e;
  const long long tiles_m = (m + kWgBM - 1) / kWgBM;
  const long long tiles_n = (n + kWgBN - 1) / kWgBN;
  if (tiles_m * tiles_n > 0x7fffffffLL) return cudaErrorInvalidValue;
  const long long tiles = tiles_m * tiles_n;
  const int sms = sm_count();
  const int grid = static_cast<int>(tiles < sms ? tiles : sms);
  matmul_wgmma_kernel<<<grid, kWgThreads, kWgSmem, stream>>>(
      map_a, map_b, map_c, tma_c, c, ldc, m, n, k,
      static_cast<int>(tiles_m), static_cast<int>(tiles_n));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* conflux_bigk_gemm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// dynamic shared memory a K2 CTA uses in 'high' (ptxas reports static
// memory only)
int conflux_sub_matmul_bigk_smem_bytes() {
  return static_cast<int>(smem_bytes<true>());
}

// K2's K splits for an [m, nt] output and depth k on the current device
int conflux_sub_matmul_bigk_splits(int m, int nt, int k) {
  return plan(m, nt, k).splits;
}

// bytes of workspace K2 needs for that call: the split copies, and the
// split-K planes where K splits
long long conflux_sub_matmul_bigk_workspace_bytes(int m, int nt, int k,
                                                  int passes) {
  return static_cast<long long>(
      workspace_bytes(plan(m, nt, k), m, nt, k, passes));
}

// out = R - A @ B on `stream`. r_bf16: R and out are bfloat16 (mode
// 'bf16out'), else float32. b_trans: B is stored transposed, B[i, j] at
// b[j * ldb + i]. passes: 3 for 'high', 1 for 'bf16'/'bf16out'.
// ws holds ws_bytes bytes, at least conflux_sub_matmul_bigk_workspace_
// bytes(m, nt, k, passes), 256-byte aligned. *route receives the kernel
// launched (1: split pass + wgmma, with the split-K sum where K splits).
// Returns 0 or a cudaError_t code (a refused launch of any of the three
// kernels included); never synchronises.
int conflux_sub_matmul_bigk(const void* r, int ldr, void* out, int ldo,
                            int r_bf16, const float* a, int lda,
                            const float* b, int ldb, int b_trans, int m,
                            int nt, int k, int passes, void* ws,
                            long long ws_bytes, void* stream, int* route) {
  if (m < 1 || nt < 1 || k < 1 || (passes != 1 && passes != 3) ||
      (passes == 3 && r_bf16))      // 'high' takes a float32 R
    return cudaErrorInvalidValue;
  const Plan p = plan(m, nt, k);
  if (ws_bytes < static_cast<long long>(workspace_bytes(p, m, nt, k,
                                                        passes)) ||
      reinterpret_cast<uintptr_t>(ws) % 256 != 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Maps maps;
  const cudaError_t e = split_operands(&maps, ws, a, lda, b, ldb,
                                       b_trans != 0, m, nt, k, passes, s);
  if (e != cudaSuccess) return e;
  float* planes = reinterpret_cast<float*>(
      static_cast<uint8_t*>(ws) + layout(m, nt, k, passes).total());
  *route = kBigkRouteWgmma;
  if (passes == 3)
    return launch_bigk<true>(maps, static_cast<const float*>(r), ldr,
                             static_cast<float*>(out), ldo, planes, m, nt, p,
                             s);
  return r_bf16 ? launch_bigk<false>(
                      maps, static_cast<const __nv_bfloat16*>(r), ldr,
                      static_cast<__nv_bfloat16*>(out), ldo, planes, m, nt,
                      p, s)
                : launch_bigk<false>(maps, static_cast<const float*>(r), ldr,
                                     static_cast<float*>(out), ldo, planes,
                                     m, nt, p, s);
}

// K2's bf16-operand entry for an [m, nt] output at depth k on the current
// device: its K splits (1: whole tiles), the bytes of workspace its
// split-K planes take (0 without split-K), the zeroed int counters it
// needs (one a tile with split-K, else 0); the ping-pong route's clusters
// the card runs at once, and the kernels' largest dynamic shared memory
int conflux_sub_matmul_bigk_bf16_splits(int m, int nt, int k) {
  return plan_bf16(m, nt, k).splits;
}
long long conflux_sub_matmul_bigk_bf16_workspace_bytes(int m, int nt, int k) {
  return static_cast<long long>(bf16_planes_bytes(plan_bf16(m, nt, k)));
}
int conflux_sub_matmul_bigk_bf16_counters(int m, int nt, int k) {
  const b16::Plan p = plan_bf16(m, nt, k);
  return p.splits > 1 ? bf16_tiles(p) : 0;
}
int conflux_sub_matmul_bigk_bf16_clusters() { return bf16_clusters(); }

// the route kind (Bf16Route, without kBf16BKMajor) the entry takes for an
// [m, nt] output at depth k whose R and out are contiguous rows of
// r_bytes-byte elements at 16-byte-aligned bases
int conflux_sub_matmul_bigk_bf16_kind(int m, int nt, int k, int r_bytes) {
  if (use_coop(m, nt, k)) return kBf16Coop;
  if (plan_bf16(m, nt, k).splits > 1) return kBf16SplitK;
  return ((long long)nt * r_bytes) % 16 == 0 ? kBf16TilesTma
                                              : kBf16TilesRegisters;
}
int conflux_sub_matmul_bigk_bf16_smem_bytes() {
  return static_cast<int>(std::max({b16::Cfg<b16::kEpiTma>::kSmem,
                                    b16::Cfg<b16::kEpiSplit>::kSmem,
                                    b16::kCoSmem}));
}

// out = R - A @ B on `stream` for bfloat16 A [m, k] (row stride lda) and
// B [k, nt], both read in place by TMA: B row-major with row stride ldb,
// or, with b_kmajor, stored transposed (B[i, j] at b[j * ldb + i], the
// stored [nt, k] rows read K-major). R float32 ('bf16') or bfloat16
// ('bf16out', r_bf16), rounded once into out. Both operands must suit
// TMA: 16-byte-aligned bases, row strides multiples of 8 elements. With
// split-K, ws holds ws_bytes bytes, at least conflux_sub_matmul_bigk_bf16_
// workspace_bytes(m, nt, k), 256-byte aligned, and counters
// counter_slots >= conflux_sub_matmul_bigk_bf16_counters(m, nt, k) ints,
// zero on entry and left zero (no other launch may use them meanwhile).
// *route receives the route (Bf16Route: 1 ping-pong tiles through TMA, 2
// ping-pong tiles from the registers, 3 ping-pong split-K, 4 cooperative
// tiles; plus 8 where B was read K-major). Returns 0 or a cudaError_t
// code; never synchronises.
int conflux_sub_matmul_bigk_bf16(const void* r, int ldr, void* out, int ldo,
                                 int r_bf16, const void* a, int lda,
                                 const void* b, int ldb, int b_kmajor, int m,
                                 int nt, int k, void* ws, long long ws_bytes,
                                 int* counters, int counter_slots,
                                 void* stream, int* route) {
  if (m < 1 || nt < 1 || k < 1 || !tma_ok(a, lda, k) ||
      !tma_ok(b, ldb, b_kmajor ? k : nt))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (r_bf16)
    return launch_bf16(static_cast<const __nv_bfloat16*>(r), ldr,
                       static_cast<__nv_bfloat16*>(out), ldo, a, lda, b, ldb,
                       b_kmajor != 0, m, nt, k, ws, ws_bytes, counters,
                       counter_slots, s, route);
  return launch_bf16(static_cast<const float*>(r), ldr,
                     static_cast<float*>(out), ldo, a, lda, b, ldb,
                     b_kmajor != 0, m, nt, k, ws, ws_bytes, counters,
                     counter_slots, s, route);
}

// C = A @ B on `stream`, C [m, n] float32 with row stride ldc; A [m, k]
// and B [k, n] both float32 (bf16 == 0) or both bfloat16 (bf16 == 1).
// *route receives the kernel launched: 0 the f32 FMA tile, 1 bf16
// mma.sync, 2 bf16 wgmma + TMA (both operands TMA-aligned, tma_ok).
// Returns 0 or a cudaError_t code; never synchronises.
int conflux_matmul(const void* a, int lda, const void* b, int ldb, float* c,
                   int ldc, int m, int n, int k, int bf16, void* stream,
                   int* route) {
  if (m < 1 || n < 1 || k < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16 && tma_ok(a, lda, k) && tma_ok(b, ldb, n)) {
    *route = kRouteWgmma;
    return launch_wgmma(a, lda, b, ldb, c, ldc, m, n, k, s);
  }
  if (bf16) {
    *route = kRouteMmaSync;
    const long long gm = (m + kHBM - 1) / kHBM, gn = (n + kHBN - 1) / kHBN;
    if (gm > 65535 || gn > 0x7fffffffLL) return cudaErrorInvalidValue;
    const dim3 grid(static_cast<unsigned>(gn), static_cast<unsigned>(gm));
    matmul_bf16_kernel<<<grid, kHThreads, 0, s>>>(
        static_cast<const uint16_t*>(a), lda,
        static_cast<const uint16_t*>(b), ldb, c, ldc, m, n, k);
    return cudaGetLastError();
  }
  *route = kRouteF32;
  const long long gm = (m + kF32BM - 1) / kF32BM;
  const long long gn = (n + kF32BN - 1) / kF32BN;
  if (gm > 65535 || gn > 0x7fffffffLL) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(gn), static_cast<unsigned>(gm));
  const uintptr_t pa = reinterpret_cast<uintptr_t>(a);
  const uintptr_t pb = reinterpret_cast<uintptr_t>(b);
  const uintptr_t pc = reinterpret_cast<uintptr_t>(c);
  const bool vec = pa % 16 == 0 && pb % 16 == 0 && pc % 16 == 0 &&
                   lda % 4 == 0 && ldb % 4 == 0 && ldc % 4 == 0;
  const float* fa = static_cast<const float*>(a);
  const float* fb = static_cast<const float*>(b);
  auto kernel = vec ? matmul_f32_kernel<true> : matmul_f32_kernel<false>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kF32Smem));
  if (e != cudaSuccess) return e;
  kernel<<<grid, kF32Threads, kF32Smem, s>>>(fa, lda, fb, ldb, c, ldc, m, n,
                                              k);
  return cudaGetLastError();
}

}  // extern "C"
