// K2's bf16-operand entry on Hopper: out = R - A @ B for bfloat16 A and B
// that the kernel reads in place, R float32 ('bf16') or bfloat16
// ('bf16out'). Replaces, for bf16 storage's operands, the TPU kernel
// conflux_tpu/ops/pallas_gemm.py:sub_matmul_pallas_bigk (kernel
// _acc_bigk_kernel) in its one-pass modes. The building blocks are
// wgmma_tile.cuh's; K2's f32 entry and K3 keep their own mainloop
// (wgmma_split.cuh).
//
// What bounds it on the H100: at the bf16 crout's first panel update (R
// [31232, 1536] f32, k = 1536) the operations (0.149 ms at 989 TFLOP/s)
// and the bytes (R read, out written, A read: 0.143 ms at 3.35 TB/s) are
// nearly equal, so the kernel approaches its bound only if R's traffic
// runs while the tensor cores multiply. A kernel whose two consumer
// warpgroups share one tile stops both to subtract and store it.
//
// Layout and schedule:
//   * Ping-pong: a persistent CTA of three warpgroups. Warpgroup 0 is the
//     producer (one thread issues TMA loads of A and B into a ring of
//     kStages stages, each with a full and an empty mbarrier); warpgroups
//     1 and 2 are consumers that take the CTA's work units in turns, each
//     unit a [128, 128] output tile (two wgmma m64n128k16 a k16 step, 128
//     fp32 accumulators a thread) over its K chunks of 64. An ordered
//     pair of mbarriers hands the tensor cores from one consumer to the
//     other when its mainloop ends, so one consumer's epilogue (subtract
//     and store) runs while the other multiplies.
//   * A stage is A [128][64] and B [64][128] bf16 (32 KB) under the
//     128-byte swizzle: A K-major; B MN-major as two [64 k][64 n] boxes
//     (B [k, n] row-major, wgmma's B-transpose bit set) or, where B is
//     stored transposed (unit row stride, as the Cholesky's view
//     F[k:k+w, :k].T), K-major [128 n][64 k] of the stored [n, k] rows,
//     read in place with the bit clear.
//   * CTAs run in 2 x 2 clusters over [256, 256] super-tiles: the two
//     CTAs of a row block each load half of its A chunk and the two of a
//     column block half of its B chunk, each half multicast by TMA into
//     both CTAs' stages (16 KB a CTA a chunk instead of 32; on the H100
//     the first crout panel update went from 0.299 to 0.277 ms). A stage
//     of a CTA is refilled once the consumers of every CTA that writes
//     into it (its row and its column of the cluster, 3 CTAs) have
//     released it: each consumer arrives on those CTAs' empty barriers,
//     at CTA scope (a cluster-scope release cost 3.5x). All CTAs of a
//     cluster walk the same units, so their rings stay in step; a
//     sub-tile past the output's edge still loads its halves.
//   * R's tile goes through shared memory: each consumer has a 32 KB
//     staging area, [128][64] f32 (two [128][32] boxes) or [128][128]
//     bf16 (two [128][64] boxes). Before its mainloop the consumer's first
//     thread TMA-loads R's first (f32: of two) column halves there; the
//     epilogue reads each element from it, subtracts the accumulator once,
//     rounds once into R's type in place, and TMA-stores the staging into
//     the output; an f32 tile's second half is loaded into the same area
//     once the first has been read out. Shared memory: 5 stages (160 KB)
//     and 2 x 32 KB staging. Where R or out breaks TMA's rules (base or
//     row stride not 16-byte aligned, or out's width not a multiple of 16
//     bytes) the epilogue reads R and writes out from the registers,
//     masked, and the ring takes 6 stages.
//   * Few tiles (under two waves) split K across units: a unit of split s
//     covers its tile's chunks [s * per, (s + 1) * per). Every split
//     writes its fp32 partial product into its own plane of the workspace,
//     fragment-major (the writer's and the reader's threads hold the same
//     elements), and bumps its tile's counter; the last to arrive sums the
//     planes in split order 0, 1, ... (a fixed order: the same bits on
//     every call), subtracts from R once, rounds once, stores, and sets
//     the counter back to 0. No second kernel.
//   * Ragged edges read as zero (TMA fills them) and stores are clipped
//     or masked; any m, n, k and any TMA-legal row stride of A and B.
//   * Long K on many tiles takes the cooperative route at the end of this
//     file instead; the C entry (bigk_gemm.cu) picks the route.

#pragma once

#include <cuda_bf16.h>

#include "wgmma_split.cuh"
#include "wgmma_tile.cuh"

namespace conflux_bf16 {

using namespace conflux_wgmma;

constexpr int kTM = 128, kTN = 128, kTK = 64;
constexpr int kCM = 2, kCN = 2;                // a cluster's CTAs: rows x cols
constexpr int kCluster = kCM * kCN;
constexpr int kEmptyArrivals = kCM + kCN - 1;  // CTAs writing into a stage
constexpr int kConsumers = 2;
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kGroupM = 4;                     // super-tile rows a group
constexpr int kABytes = kTM * kTK * 2;         // 16 KB
constexpr int kBBytes = kTK * kTN * 2;         // 16 KB
constexpr int kStageBytes = kABytes + kBBytes;
constexpr int kBoxBytes = 16384;               // [128 rows][128 bytes]
constexpr int kRBytes = 2 * kBoxBytes;         // a consumer's R staging
constexpr int kTileElems = kTM * kTN;
constexpr int kSmemMax = 232448;               // a CTA's on the H100
constexpr int kBarBytes = 256;

enum Epi { kEpiTma = 0, kEpiDirect = 1, kEpiSplit = 2 };

template <int kEpi>
struct Cfg {
  static constexpr int kStaging = kEpi == kEpiTma ? kConsumers * kRBytes : 0;
  static constexpr int kFit =
      (kSmemMax - 1024 - kBarBytes - kStaging) / kStageBytes;
  static constexpr int kStages = kFit < 6 ? kFit : 6;
  static constexpr size_t kSmem =
      1024 + (size_t)kStages * kStageBytes + kStaging + kBarBytes;
};
static_assert(Cfg<kEpiTma>::kStages >= 4 && Cfg<kEpiTma>::kSmem <= kSmemMax,
              "the ring and R's staging fit a CTA");

// the work: super-tiles of [kCM * 128, kCN * 128] (one a cluster, a
// [128, 128] tile a CTA), K in chunks of 64, split into `splits` ranges of
// `per` chunks (splits == 1: whole tiles)
struct Plan {
  int super_m, super_n, chunks, splits, per;
};

// ----------------------------------------------------------------- device

// d[64 x 128] (+)= A[64 x 16] @ B[16 x 128]: bf16 operands from shared
// memory, A K-major, B MN-major (kTnspB = 1) or K-major (0), fp32
// accumulators; scale_d = 0 overwrites d. Per thread t (warp w, lane l),
// d[4j + e] is row 16w + l/4 + 8(e/2), column 8j + 2(l%4) + e%2.
template <int kTnspB>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64],
                                                 uint64_t desc_a,
                                                 uint64_t desc_b,
                                                 int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      " %0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p, 1, 1, 0, %67;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(kTnspB));
}

// d[64 x 256] (+)= A[64 x 16] @ B[16 x 256]: as wgmma_m64n128k16, B
// MN-major (kTnspB = 1) or K-major (0); d[4j + e] is row 16w + l/4 +
// 8(e/2), column 8j + 2(l%4) + e%2 of the thread's warp w, lane l
template <int kTnspB>
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128],
                                                 uint64_t desc_a,
                                                 uint64_t desc_b,
                                                 int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      " %0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63,"
      " %64, %65, %66, %67, %68, %69, %70, %71,"
      " %72, %73, %74, %75, %76, %77, %78, %79,"
      " %80, %81, %82, %83, %84, %85, %86, %87,"
      " %88, %89, %90, %91, %92, %93, %94, %95,"
      " %96, %97, %98, %99, %100, %101, %102, %103,"
      " %104, %105, %106, %107, %108, %109, %110, %111,"
      " %112, %113, %114, %115, %116, %117, %118, %119,"
      " %120, %121, %122, %123, %124, %125, %126, %127},"
      " %128, %129, p, 1, 1, 0, %131;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(kTnspB));
}

// the t-th of [rows, cols] (super-)tiles, its row and column, in grouped
// order (`group` rows a group, for L2 reuse of A's rows)
__device__ __forceinline__ void super_origin(int t, int rows, int cols,
                                             int group, int& srow,
                                             int& scol) {
  const int per_group = group * cols;
  const int first_m = (t / per_group) * group;
  const int group_m = min(rows - first_m, group);
  srow = first_m + (t % per_group) % group_m;
  scol = (t % per_group) / group_m;
}

// ------------------------------------------------------------- clusters

// every thread of every CTA of the cluster (warps converged)
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// one arrival on the barrier at bar's offset in the cluster's CTA `cta`
__device__ __forceinline__ void mbar_arrive_cta(uint64_t* bar, uint32_t cta) {
  asm volatile(
      "{\n"
      ".reg .b32 remote;\n"
      "mapa.shared::cluster.u32 remote, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [remote];\n"
      "}\n"
      :: "r"(smem_u32(bar)), "r"(cta) : "memory");
}

// TMA: the box of `map` at (c0, c1) into dst of every CTA of `mask`,
// completing on the barrier at bar's offset in each
__device__ __forceinline__ void tma_load_2d_multicast(void* dst,
                                                      const CUtensorMap* map,
                                                      uint64_t* bar, int c0,
                                                      int c1, uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.multicast::cluster [%0], [%1, {%4, %5}], [%2], %3;\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "h"(mask), "r"(c0), "r"(c1)
      : "memory");
}

// this CTA's place in its cluster: row cm, column cn; the CTAs that share
// its A rows (row_mask) and its B columns (col_mask)
struct Place {
  int cm, cn;
  uint16_t row_mask, col_mask;
};

__device__ __forceinline__ Place place_of(int rank) {
  Place q;
  q.cm = rank / kCN;
  q.cn = rank % kCN;
  q.row_mask = static_cast<uint16_t>(((1u << kCN) - 1) << (q.cm * kCN));
  q.col_mask = 0;
  for (int i = 0; i < kCM; ++i)
    q.col_mask = static_cast<uint16_t>(q.col_mask | (1u << (i * kCN + q.cn)));
  return q;
}

// ring position, the same sequence in the producer and both consumers
template <int kStages>
struct Pos {
  int stage = 0;
  uint32_t phase = 0;
  __device__ __forceinline__ void next() {
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1;
    }
  }
  // past the n chunks of a unit the other consumer takes
  __device__ __forceinline__ void skip(int n) {
    const int total = stage + n;
    stage = total % kStages;
    phase ^= static_cast<uint32_t>(total / kStages) & 1u;
  }
};

// unit u of plan p for the CTA at q: its tile (index in the grid of
// tiles padded to whole super-tiles, and origin) and K chunks
// [kc0, kc0 + nk)
struct Unit {
  int tile, split, row0, col0, kc0, nk;
};

__device__ __forceinline__ Unit unit_of(int u, const Plan& p,
                                        const Place& q) {
  Unit w;
  const int supers = p.super_m * p.super_n;
  int srow, scol;
  super_origin(u % supers, p.super_m, p.super_n, kGroupM, srow, scol);
  const int tr = srow * kCM + q.cm, tc = scol * kCN + q.cn;
  w.tile = tr * (p.super_n * kCN) + tc;
  w.split = u / supers;
  w.row0 = tr * kTM;
  w.col0 = tc * kTN;
  w.kc0 = w.split * p.per;
  w.nk = min(p.per, p.chunks - w.kc0);
  return w;
}

// producer (one thread): the unit's K chunks into the ring of every CTA
// of its row (its slice cn of A's 128 rows) and column (its slice cm of
// B's 128 columns); each stage expects all 32 KB that land in this CTA
template <int kStages, bool kBT>
__device__ __forceinline__ void produce(const CUtensorMap* map_a,
                                        const CUtensorMap* map_b,
                                        uint8_t* ring, uint64_t* full,
                                        uint64_t* empty, Pos<kStages>& pos,
                                        const Unit& w, const Place& q) {
  constexpr int kBoxesB = kTN / 64 / kCM;       // MN-major boxes a slice
  for (int kc = w.kc0; kc < w.kc0 + w.nk; ++kc) {
    mbar_wait(&empty[pos.stage], pos.phase ^ 1);
    uint8_t* st = ring + pos.stage * kStageBytes;
    uint64_t* bar = &full[pos.stage];
    mbar_expect_tx(bar, kStageBytes);
    tma_load_2d_multicast(st + q.cn * (kABytes / kCN), map_a, bar, kc * kTK,
                          w.row0 + q.cn * (kTM / kCN), q.row_mask);
    if (kBT) {
      tma_load_2d_multicast(st + kABytes + q.cm * (kBBytes / kCM), map_b,
                            bar, kc * kTK, w.col0 + q.cm * (kTN / kCM),
                            q.col_mask);
    } else {
#pragma unroll
      for (int j = 0; j < kBoxesB; ++j) {
        const int box = q.cm * kBoxesB + j;
        tma_load_2d_multicast(st + kABytes + box * (kBBytes / 2), map_b,
                              bar, w.col0 + 64 * box, kc * kTK, q.col_mask);
      }
    }
    pos.next();
  }
}

// a released stage: one arrival on its empty barrier in every CTA that
// writes into this one (its row and its column of the cluster)
__device__ __forceinline__ void release(uint64_t* empty, const Place& q) {
  for (int j = 0; j < kCN; ++j) mbar_arrive_cta(empty, q.cm * kCN + j);
  for (int i = 0; i < kCM; ++i)
    if (i != q.cm) mbar_arrive_cta(empty, i * kCN + q.cn);
}

// consumer: acc = the unit's A @ B over its nk chunks, each stage
// released once its wgmmas are done
template <int kStages, bool kBT>
__device__ __forceinline__ void consume(float (&acc)[2][64], uint8_t* ring,
                                        uint64_t* full, uint64_t* empty,
                                        Pos<kStages>& pos, int tid, int nk,
                                        const Place& q) {
  int prev = -1;
  for (int kc = 0; kc < nk; ++kc) {
    mbar_wait(&full[pos.stage], pos.phase);
    const uint8_t* a = ring + pos.stage * kStageBytes;
    const uint8_t* b = a + kABytes;
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < kTK / 16; ++s) {
      // K-major B: like A, 32 bytes a k16 step; MN-major B: 16 rows of
      // 128 bytes a k16 step, 8 KB between its two 64-column boxes
      const uint64_t db = kBT ? smem_desc(b + 32 * s, 16, 1024)
                              : smem_desc(b + 2048 * s, kBBytes / 2, 1024);
      const int sd = kc > 0 || s > 0;
      wgmma_m64n128k16<kBT ? 0 : 1>(acc[0], smem_desc(a + 32 * s, 16, 1024),
                                    db, sd);
      wgmma_m64n128k16<kBT ? 0 : 1>(
          acc[1], smem_desc(a + 64 * 128 + 32 * s, 16, 1024), db, sd);
    }
    wgmma_commit();
    wgmma_wait<1>();          // chunk kc - 1's products are done
    if (prev >= 0 && tid == 0) release(&empty[prev], q);
    prev = pos.stage;
    pos.next();
  }
  wgmma_wait<0>();
  if (prev >= 0 && tid == 0) release(&empty[prev], q);
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < 64; ++i) fence_operand(acc[h][i]);
}

// R's and out's element loads and stores, K2's (wgmma_split.cuh)
using conflux_split::ld1;
using conflux_split::ld2;
using conflux_split::st1;
using conflux_split::st2;

// R's column half `half` of the tile at (row0, col0) (f32: 64 columns;
// bf16: all 128) into the staging area rs, on bar (one thread)
template <typename T>
__device__ __forceinline__ void load_r(const CUtensorMap* map_r, uint8_t* rs,
                                       uint64_t* bar, int row0, int col0,
                                       int half) {
  constexpr int kCols = 128 / sizeof(T);          // a box's columns
  mbar_expect_tx(bar, kRBytes);
#pragma unroll
  for (int b = 0; b < 2; ++b)
    tma_load_2d(rs + b * kBoxBytes, map_r, bar,
                col0 + half * 2 * kCols + b * kCols, row0);
}

// The TMA epilogue of one staged half: rs = round(R - acc) in place for
// this thread's elements of the half, then (first thread) TMA stores of
// the two boxes into out. Accumulator pair (h, j, e2) is row
// 64 h + 16 w + l/4 + 8 e2, columns 8 j + 2 (l%4) + {0, 1}; in the
// staging, the 16-byte chunk c of row r lands at c ^ (r % 8), and
// r % 8 == l / 4.
template <typename T>
__device__ __forceinline__ void epilogue_staged(const float (&acc)[2][64],
                                                uint8_t* rs, int half,
                                                const CUtensorMap* map_o,
                                                int row0, int col0,
                                                int barrier_id) {
  constexpr bool kF32 = sizeof(T) == 4;
  constexpr int kCols = 128 / sizeof(T);
  const int tid = threadIdx.x % 128;
  const int lane = tid % 32, warp = tid / 32;
  const int j0 = kF32 ? 8 * half : 0, j1 = kF32 ? j0 + 8 : 16;
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int e2 = 0; e2 < 2; ++e2) {
      const int row = 64 * h + 16 * warp + lane / 4 + 8 * e2;
#pragma unroll
      for (int j = j0; j < j1; ++j) {
        const int col = 8 * j + 2 * (lane % 4) - 2 * kCols * half;
        const int box = col / kCols, inner = (col % kCols) * sizeof(T);
        const int chunk = inner / 16;
        T* p = reinterpret_cast<T*>(rs + box * kBoxBytes + row * 128 +
                                    ((chunk ^ (lane / 4)) * 16) +
                                    inner % 16);
        const float2 x = ld2(p);
        st2(p, __fsub_rn(x.x, acc[h][4 * j + 2 * e2]),
            __fsub_rn(x.y, acc[h][4 * j + 2 * e2 + 1]));
      }
    }
  fence_proxy_async();        // the writes, visible to the TMA store
  named_sync(barrier_id, 128);
  if (tid == 0) {
#pragma unroll
    for (int b = 0; b < 2; ++b)
      tma_store_2d(map_o, rs + b * kBoxBytes,
                   col0 + half * 2 * kCols + b * kCols, row0);
    bulk_commit();
  }
}

// The epilogue from the registers: out = round(R - acc), R read and out
// written straight from device memory, masked to [0, m) x [0, nt); pairs
// as float2 / bf16x2 where vec2r / vec2o
template <typename T>
__device__ __forceinline__ void epilogue_direct(
    const float (&acc)[2][64], const T* r, int ldr, bool vec2r, T* out,
    int ldo, bool vec2o, int m, int nt, int row0, int col0) {
  const int tid = threadIdx.x % 128;
  const int lane = tid % 32, warp = tid / 32;
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int e2 = 0; e2 < 2; ++e2) {
      const int gr = row0 + 64 * h + 16 * warp + lane / 4 + 8 * e2;
      if (gr >= m) continue;
      float x[32];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int gc = col0 + 8 * j + 2 * (lane % 4);
        x[2 * j] = x[2 * j + 1] = 0.f;
        if (gc >= nt) continue;
        const T* p = r + (size_t)gr * ldr + gc;
        if (vec2r && gc + 1 < nt) {
          const float2 v = ld2(p);
          x[2 * j] = v.x;
          x[2 * j + 1] = v.y;
        } else {
          x[2 * j] = ld1(p);
          if (gc + 1 < nt) x[2 * j + 1] = ld1(p + 1);
        }
      }
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int gc = col0 + 8 * j + 2 * (lane % 4);
        if (gc >= nt) continue;
        T* p = out + (size_t)gr * ldo + gc;
        const float o0 = __fsub_rn(x[2 * j], acc[h][4 * j + 2 * e2]);
        const float o1 = __fsub_rn(x[2 * j + 1], acc[h][4 * j + 2 * e2 + 1]);
        if (vec2o && gc + 1 < nt) {
          st2(p, o0, o1);
        } else {
          st1(p, o0);
          if (gc + 1 < nt) st1(p + 1, o1);
        }
      }
    }
}

// Split-K: this split's partial product into its plane (fragment-major:
// float4 i of thread t at [i * 128 + t]); the tile's last split to arrive
// sums the planes in split order into acc and returns true (and sets the
// tile's counter back to 0)
__device__ __forceinline__ bool split_arrive(float (&acc)[2][64],
                                             float* planes, int* counters,
                                             const Unit& w, int splits,
                                             int* flag, int barrier_id) {
  const int tid = threadIdx.x % 128;
  float4* mine = reinterpret_cast<float4*>(
      planes + ((size_t)w.tile * splits + w.split) * kTileElems);
#pragma unroll
  for (int i = 0; i < 32; ++i)
    mine[i * 128 + tid] =
        make_float4(acc[i / 16][4 * (i % 16)], acc[i / 16][4 * (i % 16) + 1],
                    acc[i / 16][4 * (i % 16) + 2],
                    acc[i / 16][4 * (i % 16) + 3]);
  __threadfence();            // the plane, visible before the count
  named_sync(barrier_id, 128);
  if (tid == 0) *flag = atomicAdd(&counters[w.tile], 1) == splits - 1;
  named_sync(barrier_id, 128);
  if (!*flag) return false;
  __threadfence();
  for (int s = 0; s < splits; ++s) {
    const float4* ps = reinterpret_cast<const float4*>(
        planes + ((size_t)w.tile * splits + s) * kTileElems);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float4 v = __ldcg(ps + i * 128 + tid);
      const int h = i / 16, j = 4 * (i % 16);
      acc[h][j] = s ? __fadd_rn(acc[h][j], v.x) : v.x;
      acc[h][j + 1] = s ? __fadd_rn(acc[h][j + 1], v.y) : v.y;
      acc[h][j + 2] = s ? __fadd_rn(acc[h][j + 2], v.z) : v.z;
      acc[h][j + 3] = s ? __fadd_rn(acc[h][j + 3], v.w) : v.w;
    }
  }
  if (tid == 0) counters[w.tile] = 0;   // ready for the next call
  return true;
}

// out = R - A @ B over the units of plan p. kBT: B's map is over the
// stored [n, k] rows of a transposed B. kEpi: the epilogue (kEpiTma:
// map_r and map_o over R and out; kEpiDirect: r and out from the
// registers; kEpiSplit: planes and counters as well).
template <typename T, bool kBT, int kEpi>
__global__ void __launch_bounds__(kThreads, 1) sub_matmul_bf16_kernel(
    const __grid_constant__ CUtensorMap map_a,
    const __grid_constant__ CUtensorMap map_b,
    const __grid_constant__ CUtensorMap map_r,
    const __grid_constant__ CUtensorMap map_o, const T* r, int ldr, T* out,
    int ldo, float* planes, int* counters, int m, int nt, Plan p) {
  using C = Cfg<kEpi>;
  constexpr int kStages = C::kStages;
  extern __shared__ uint8_t bf16_smem_raw[];
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(bf16_smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* staging = ring + kStages * kStageBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(staging + C::kStaging);
  uint64_t* empty = full + kStages;
  uint64_t* r_full = empty + kStages;          // [kConsumers]
  uint64_t* order = r_full + kConsumers;       // [kConsumers]
  int* flag = reinterpret_cast<int*>(order + kConsumers);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kEmptyArrivals);
    }
    for (int c = 0; c < kConsumers; ++c) {
      mbar_init(&r_full[c], 1);
      mbar_init(&order[c], 1);
    }
    fence_barrier_init();
  }
  // the peers' barriers are initialised before any multicast or arrival
  cluster_sync();
  const Place q = place_of(blockIdx.x % kCluster);
  const int cluster = blockIdx.x / kCluster;
  const int clusters = gridDim.x / kCluster;
  const int units = p.super_m * p.super_n * p.splits;
  const int wg = threadIdx.x / 128;

  if (wg == 0) {
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      Pos<kStages> pos;
      for (int u = cluster; u < units; u += clusters)
        produce<kStages, kBT>(&map_a, &map_b, ring, full, empty, pos,
                              unit_of(u, p, q), q);
    }
    __syncwarp();
    // no CTA leaves while a peer may still write into it or arrive on its
    // barriers
    cluster_sync();
    return;
  }

  setmaxnreg_inc<232>();
  const int c = wg - 1;                  // this consumer
  const int tid = threadIdx.x % 128;
  const bool vec2r = ldr % 2 == 0 &&
                     reinterpret_cast<uintptr_t>(r) % (2 * sizeof(T)) == 0;
  const bool vec2o = ldo % 2 == 0 &&
                     reinterpret_cast<uintptr_t>(out) % (2 * sizeof(T)) == 0;
  uint8_t* rs = staging + c * kRBytes;
  constexpr int kHalves = kEpi == kEpiTma && sizeof(T) == 4 ? 2 : 1;
  uint32_t r_phase = 0, order_phase = 0;
  float acc[2][64];
  Pos<kStages> pos;
  int i = 0;
  for (int u = cluster; u < units; u += clusters, ++i) {
    const Unit w = unit_of(u, p, q);
    if ((i & 1) != c) {                 // the other consumer's unit
      pos.skip(w.nk);
      continue;
    }
    if (kEpi == kEpiTma && tid == 0) {
      bulk_wait_read<0>();             // the last store has left rs
      load_r<T>(&map_r, rs, &r_full[c], w.row0, w.col0, 0);
    }
    if (i > 0) {                        // the tensor cores' turn
      mbar_wait(&order[c], order_phase);
      order_phase ^= 1;
    }
    consume<kStages, kBT>(acc, ring, full, empty, pos, tid, w.nk, q);
    if (tid == 0) mbar_arrive(&order[c ^ 1]);
    if constexpr (kEpi == kEpiTma) {
#pragma unroll
      for (int half = 0; half < kHalves; ++half) {
        if (half > 0 && tid == 0) {
          bulk_wait_read<0>();
          load_r<T>(&map_r, rs, &r_full[c], w.row0, w.col0, half);
        }
        mbar_wait(&r_full[c], r_phase);
        r_phase ^= 1;
        epilogue_staged<T>(acc, rs, half, &map_o, w.row0, w.col0, 1 + c);
      }
    } else if constexpr (kEpi == kEpiDirect) {
      epilogue_direct<T>(acc, r, ldr, vec2r, out, ldo, vec2o, m, nt, w.row0,
                         w.col0);
    } else {
      if (split_arrive(acc, planes, counters, w, p.splits, &flag[c], 1 + c))
        epilogue_direct<T>(acc, r, ldr, vec2r, out, ldo, vec2o, m, nt,
                           w.row0, w.col0);
    }
  }
  if (kEpi == kEpiTma && tid == 0) bulk_wait_all();   // the stores are done
  __syncwarp();
  cluster_sync();
}

// ------------------------------------------------- the cooperative route
//
// Long K on many tiles: the tensor cores' rate decides, and a consumer's
// m64n128 products on a [128, 128] tile run slower than m64n256 ones (the
// ping-pong route ran the mid crout steps ~10 % slower than K2's [128,
// 256] kernel, with or without its clusters' multicast, so L2 reads were
// not what bound it). There both consumers share a [128, 256] tile, 64
// rows each (wgmma m64n256k16, 128 accumulators a thread), 4 stages of 48
// KB (A [128][64], B as four [64 k][64 n] boxes or one K-major [256 n][64
// k] box), and K2's epilogue (wgmma_split.cuh store_block: R's first
// quarter read during the mainloop, out through TMA stores). CTAs run in
// 2 x 1 clusters over [256, 256] super-tiles whose two row tiles share B:
// each CTA loads half of B's chunk and multicasts it into both, and a
// stage is refilled once both CTAs' consumers have released it (in the
// bf16 crout on the H100 its K2 time fell from 32.4 to 30.9 ms against
// the same route without clusters).

constexpr int kCoBN = 256, kCoGroupM = 8;
constexpr int kCoCM = 2;               // CTAs of a cluster that share B
constexpr int kCoBBytes = kTK * kCoBN * 2;                 // 32 KB
constexpr int kCoStageBytes = kABytes + kCoBBytes;         // 48 KB
constexpr int kCoStages = 4;
constexpr size_t kCoSmem = 1024 + (size_t)kCoStages * kCoStageBytes +
                           kConsumers * conflux_split::kCStageBytes +
                           kBarBytes;
static_assert(kCoSmem <= kSmemMax, "the cooperative ring fits a CTA");

// super-tiles of [kCoCM * 128, 256], one a cluster (a [128, 256] tile a
// CTA), in grouped order (kCoGroupM row tiles a group)
struct CoPlan {
  int super_m, tiles_n, chunks;
};

// the cooperative kernel: out = R - A @ B over the tiles of p; map_o over
// out in [64][128-byte] boxes where tma_o, else out from the registers
template <typename T, bool kBT>
__global__ void __launch_bounds__(kThreads, 1) sub_matmul_bf16_coop_kernel(
    const __grid_constant__ CUtensorMap map_a,
    const __grid_constant__ CUtensorMap map_b,
    const __grid_constant__ CUtensorMap map_o, bool tma_o, const T* r,
    int ldr, T* out, int ldo, int m, int nt, CoPlan p) {
  extern __shared__ uint8_t coop_smem_raw[];
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(coop_smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* cstage = ring + kCoStages * kCoStageBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(
      cstage + kConsumers * conflux_split::kCStageBytes);
  uint64_t* empty = full + kCoStages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kCoStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers * kCoCM);   // both CTAs' consumers
    }
    fence_barrier_init();
  }
  cluster_sync();
  const int rank = blockIdx.x % kCoCM;
  const int cluster = blockIdx.x / kCoCM, clusters = gridDim.x / kCoCM;
  const int units = p.super_m * p.tiles_n;
  const int wg = threadIdx.x / 128;

  if (wg == 0) {
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      constexpr uint16_t kAll = (1u << kCoCM) - 1;
      Pos<kCoStages> pos;
      for (int u = cluster; u < units; u += clusters) {
        int srow, scol;
        super_origin(u, p.super_m, p.tiles_n, kCoGroupM / kCoCM, srow, scol);
        const int row0 = (srow * kCoCM + rank) * kTM, col0 = scol * kCoBN;
        for (int kc = 0; kc < p.chunks; ++kc) {
          mbar_wait(&empty[pos.stage], pos.phase ^ 1);
          uint8_t* st = ring + pos.stage * kCoStageBytes;
          uint64_t* bar = &full[pos.stage];
          mbar_expect_tx(bar, kCoStageBytes);
          tma_load_2d(st, &map_a, bar, kc * kTK, row0);
          // this CTA's slice of B's 256 columns, into both CTAs
          if (kBT) {
            tma_load_2d_multicast(st + kABytes + rank * (kCoBBytes / kCoCM),
                                  &map_b, bar, kc * kTK,
                                  col0 + rank * (kCoBN / kCoCM), kAll);
          } else {
#pragma unroll
            for (int j = 0; j < kCoBN / 64 / kCoCM; ++j) {
              const int b = rank * (kCoBN / 64 / kCoCM) + j;
              tma_load_2d_multicast(st + kABytes + b * 8192, &map_b, bar,
                                    col0 + 64 * b, kc * kTK, kAll);
            }
          }
          pos.next();
        }
      }
    }
    __syncwarp();
    // no CTA leaves while its peer may still write into it or arrive on
    // its barriers
    cluster_sync();
    return;
  }

  setmaxnreg_inc<232>();
  const int cw = wg - 1;                   // this consumer's 64 rows
  const int tid = threadIdx.x % 128;
  const bool vec2r = ldr % 2 == 0 &&
                     reinterpret_cast<uintptr_t>(r) % (2 * sizeof(T)) == 0;
  const bool vec2o = ldo % 2 == 0 &&
                     reinterpret_cast<uintptr_t>(out) % (2 * sizeof(T)) == 0;
  uint8_t* cs = cstage + cw * conflux_split::kCStageBytes;
  float acc[128];
  Pos<kCoStages> pos;
  for (int u = cluster; u < units; u += clusters) {
    int srow, scol;
    super_origin(u, p.super_m, p.tiles_n, kCoGroupM / kCoCM, srow, scol);
    const int row0 = (srow * kCoCM + rank) * kTM, col0 = scol * kCoBN;
    int gr0, gc0;
    conflux_split::block_origin(row0, col0, cw, gr0, gc0);
    float cur[32];
    // R's first quarter is in flight during the mainloop
    conflux_split::load_quarter(r, ldr, m, nt, gr0, gc0, 0, vec2r, cur);
    int prev = -1;
    for (int kc = 0; kc < p.chunks; ++kc) {
      mbar_wait(&full[pos.stage], pos.phase);
      const uint8_t* a = ring + pos.stage * kCoStageBytes + cw * 64 * 128;
      const uint8_t* b = ring + pos.stage * kCoStageBytes + kABytes;
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < kTK / 16; ++s) {
        const uint64_t db = kBT ? smem_desc(b + 32 * s, 16, 1024)
                                : smem_desc(b + 2048 * s, 8192, 1024);
        wgmma_m64n256k16<kBT ? 0 : 1>(acc, smem_desc(a + 32 * s, 16, 1024),
                                      db, kc > 0 || s > 0);
      }
      wgmma_commit();
      wgmma_wait<1>();        // chunk kc - 1's products are done
      if (prev >= 0 && tid == 0)
        for (int c = 0; c < kCoCM; ++c) mbar_arrive_cta(&empty[prev], c);
      prev = pos.stage;
      pos.next();
    }
    wgmma_wait<0>();
    if (prev >= 0 && tid == 0)
      for (int c = 0; c < kCoCM; ++c) mbar_arrive_cta(&empty[prev], c);
#pragma unroll
    for (int i = 0; i < 128; ++i) fence_operand(acc[i]);
    conflux_split::store_block<true>(acc, cur, r, ldr, vec2r, out, ldo, vec2o,
                                     &map_o, tma_o, 0, m, nt, row0, col0, cw,
                                     cs);
  }
  if (tid == 0) bulk_wait_all();           // the TMA stores are done
  __syncwarp();
  cluster_sync();
}

}  // namespace conflux_bf16
