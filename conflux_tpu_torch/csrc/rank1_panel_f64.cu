// K1 in double: the masked-argmax partial-pivoting rank-1 elimination of a
// transposed float64 panel block, by hand for Hopper (sm_90a).
//
// Replaces the TPU kernel conflux_tpu/ops/pallas_panel.py:_rank1_kernel
// (wrapper rank1_block_pallas_t) for the float64 panels of the JAX
// package's x64 mode. Same contract as the float32 K1 (rank1_panel.cu):
//   Mt [w, m] f64 (panel columns as rows, matrix rows as lanes),
//   avail [1, m] f64 (> 0 = selectable)
//   -> Mt' [w, m], avail' [1, m], piv [w] i32, ok [w] i32.
// For each column jj in order: pick the available lane p of largest |Mt[jj]|
// (lowest lane on ties, NaN ranks highest, as jnp.argmax), or p = j0 + jj
// in forced mode; store col / pivot (a true division; a zero pivot divides
// by 1) as the multipliers of the other available lanes in row jj; update
// rows jj+1..w-1 of those lanes by the rank-1 product x - pivcol * mult,
// the product rounded before the subtraction (no fused multiply-add);
// retire lane p. Pivot lanes keep the merged-factor values they held when
// selected, which is what the forced and finish modes ask for, so all
// three modes run the same code on every route.
//
// What bounds it on the H100: latency, as for the float32 kernel. The w
// columns form a chain (each column's pivot search spans every lane and
// the next column depends on it); the bytes (32 MiB at [128, 32768]) would
// take 10 us, the card's fp64 rate ~2 us. Beside the chain, each column's
// update reads and writes the live rows of every lane: 16 bytes a lane and
// row in double, which shared memory serves at 128 bytes a cycle per SM,
// and which the L2 serves far more slowly. So every route keeps its slab
// on chip. Three routes, chosen from (w, m) and the mode alone, as the
// float32 kernel's:
//   * tile route, forced blocks up to w = 128 (the pivot-row refactor of
//     the LU schemes, every Cholesky diagonal tile): the pivots are known,
//     so each CTA eliminates its own 64 lanes together with a copy of the
//     w pivot lanes and never waits for another CTA. A [w, 64 + w] slab is
//     192 KB in double at w = 128 (the float32 kernel's 128 own lanes
//     would need 257 KB);
//   * cluster route, other blocks of at most 16 x 128 lanes (the last
//     panels): one thread-block cluster. Each CTA pushes its candidate
//     record (a double score, the lane and its avail bit) and the
//     candidate's column into every peer's shared memory with st.async,
//     which completes bytes on the peer's mbarrier; every CTA reduces the
//     records in the same order and copies the winner's column from its
//     own shared memory. The float32 kernel's lookahead (row c+1 first,
//     then the candidate for c+1, then the rest of column c's update)
//     left that rest on the chain in double, so the CTA's warps split:
//     four run the chain while four apply the previous column's bulk
//     update. A column word is computed once and pushed to every peer
//     (computing it again for each peer cost 0.1 ms of 0.45 at
//     [128, 2048] on the H100);
//   * grid route, wider blocks: one persistent cooperative launch, one
//     CTA per SM and one lane per thread. Per column each CTA publishes
//     its candidate with that lane's column values, one grid barrier makes
//     them visible, and every CTA reduces the candidates in the same
//     order. The slab stays on chip up to 256 lanes a CTA (33792 lanes on
//     132 SMs, every block the float64 paths launch at N = 32768): a
//     [128, 249]-lane slab is 255 KB, more than a CTA's 227 KB of shared
//     memory, so its last 16 rows (32 where 16 are not enough) live in the
//     registers of the thread that owns the lane and the rest in shared
//     memory. Wider blocks work on the output in global memory, through
//     the L2 (at [128, 32768] that layout took 1.6 ms on the H100, the
//     on-chip one 0.66 ms).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <climits>
#include <cmath>
#include <cstdint>
#include <mutex>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 16;       // non-portable cluster size
constexpr int kClusterLanes = 128;    // lanes a cluster CTA holds, at most
constexpr int kMinClusterLanes = 64;  // ... and, where m allows, at least
constexpr int kTileLanes = 64;        // own lanes of a tile CTA
constexpr int kTileMaxW = 128;
constexpr int kRegRows = 32;          // grid route: rows in registers, at most
constexpr int kMinGridLanes = 64;     // grid route: lanes a CTA takes, at least
constexpr int kGlobalLanes = 256;     // global-slab grid route: lanes a CTA aims at
constexpr int kMaxGrid = 1024;        // bound of the grid scratch layout
constexpr int kHead = 4;              // score, lane, avail[lane], pad
constexpr int kMaxDevices = 64;

enum Route { kRouteCluster = 1, kRouteGrid = 2, kRouteTile = 3 };

// argmax order: larger score wins, NaN beats any number, lower lane on ties
__device__ __forceinline__ bool better(double a, int ia, double b, int ib) {
  const bool na = isnan(a), nb = isnan(b);
  if (na || nb) return na && (!nb || ia < ib);
  return a > b || (a == b && ia < ib);
}

__device__ __forceinline__ void warp_best(double& s, int& i, int& c) {
  for (int off = 16; off > 0; off >>= 1) {
    const double os = __shfl_down_sync(0xffffffffu, s, off);
    const int oi = __shfl_down_sync(0xffffffffu, i, off);
    const int oc = __shfl_down_sync(0xffffffffu, c, off);
    if (better(os, oi, s, i)) {
      s = os;
      i = oi;
      c = oc;
    }
  }
}

// the CTA's candidate from each thread's (best, bi): every thread gets the
// same; a real lane of the CTA where one thread holds one (-inf ties go
// low). Holds one __syncthreads; red_s / red_i are rewritten only after
// the caller's next barrier.
__device__ __forceinline__ void cta_best(double& best, int& bi,
                                         double* red_s, int* red_i) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int unused = 0;
  warp_best(best, bi, unused);
  if (lane == 0) {
    red_s[warp] = best;
    red_i[warp] = bi;
  }
  __syncthreads();
  best = red_s[lane % kWarps];
  bi = red_i[lane % kWarps];
  warp_best(best, bi, unused);
  best = __shfl_sync(0xffffffffu, best, 0);
  bi = __shfl_sync(0xffffffffu, bi, 0);
}

// x - p * mu with the product rounded first
__device__ __forceinline__ double rank1(double x, double p, double mu) {
  return __dsub_rn(x, __dmul_rn(p, mu));
}

struct Args {
  const double* mt_in;
  const double* avail_in;
  double* mt_out;
  double* avail_out;
  int* piv;
  int* ok;
  double* head;   // grid route: [2][grid][kHead] candidate records
  double* cols;   // grid route: [2][grid][w] each candidate's column values
  int w, m, lanes, forced, j0;
};

// --------------------------------------------------------------- tile route

// Forced blocks (w <= kTileMaxW): lane j0 + jj is column jj's pivot, so no
// CTA waits for another. Each CTA holds its own kTileLanes lanes and a copy
// of the w pivot lanes (the tile), one thread a lane, and eliminates them
// all together; column jj's pivot column is the tile's lane jj after the
// columns before it, in the CTA's own shared memory. Each lane's updates
// are the same operations in the same order as on the other routes, so a
// tile lane and its owner's copy agree bit for bit. One barrier a column.

// dynamic shared memory of a tile CTA: avail and the [w, nt] slab of its
// nt = lanes + w lanes with an odd row stride
size_t tile_smem_bytes(int w, int nt) {
  return ((size_t)nt + (size_t)w * (nt | 1)) * sizeof(double);
}

__global__ void __launch_bounds__(kThreads, 1) rank1_f64_tile_kernel(Args a) {
  extern __shared__ double tile_smem[];
  const int w = a.w, m = a.m, j0 = a.j0;
  const int tid = threadIdx.x;
  const int lane0 = blockIdx.x * a.lanes;
  const int nl = min(a.lanes, m - lane0);
  const int nt = nl + w;               // own lanes, then the tile's
  const size_t ld = nt | 1;
  double* av = tile_smem;              // [nt]
  double* S = tile_smem + nt;          // [w][ld]
  // slab lane i: own lane lane0 + i (i < nl), or tile lane j0 + i - nl
  auto global_lane = [&](int i) { return i < nl ? lane0 + i : j0 + i - nl; };
  for (int r = 0; r < w; ++r)
    for (int i = tid; i < nt; i += kThreads)
      S[r * ld + i] = a.mt_in[(size_t)r * m + global_lane(i)];
  for (int i = tid; i < nt; i += kThreads) av[i] = a.avail_in[global_lane(i)];
  __syncthreads();

  for (int jj = 0; jj < w; ++jj) {
    const double* pc = S + nl + jj;    // the pivot lane's column, stride ld
    const double pv = pc[jj * ld];
    const double safe = pv == 0.0 ? 1.0 : pv;
    for (int i = tid; i < nt; i += kThreads) {
      if (global_lane(i) == j0 + jj) {
        av[i] = 0.0;
        continue;
      }
      if (!(av[i] > 0.0)) continue;
      const double mu = __ddiv_rn(S[jj * ld + i], safe);
      S[jj * ld + i] = mu;
      // the pivot lane is retired, so its column stays as read; four
      // rows' loads are issued before their stores
      int r = jj + 1;
      for (; r + 3 < w; r += 4) {
        double x[4], pr[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          x[u] = S[(r + u) * ld + i];
          pr[u] = pc[(r + u) * ld];
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) S[(r + u) * ld + i] = rank1(x[u], pr[u], mu);
      }
      for (; r < w; ++r) S[r * ld + i] = rank1(S[r * ld + i], pc[r * ld], mu);
    }
    __syncthreads();   // the next pivot lane is whole
  }

  if (blockIdx.x == 0)
    for (int jj = tid; jj < w; jj += kThreads) {
      a.piv[jj] = j0 + jj;
      a.ok[jj] = a.avail_in[j0 + jj] > 0.0 ? 1 : 0;
    }
  for (int r = 0; r < w; ++r)
    for (int i = tid; i < nl; i += kThreads)
      a.mt_out[(size_t)r * m + lane0 + i] = S[r * ld + i];
  for (int i = tid; i < nl; i += kThreads) a.avail_out[lane0 + i] = av[i];
}

// ------------------------------------------------------------ cluster route

// this CTA's shared address `p` as seen from CTA `rank` of the cluster
__device__ __forceinline__ uint32_t map_rank(const void* p, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(p))),
                 "r"(rank));
  return r;
}
// a 16-byte store into a peer's shared memory that completes its bytes on
// the peer's mbarrier (both cluster addresses from map_rank)
__device__ __forceinline__ void st_async(uint32_t dst, uint32_t x0,
                                         uint32_t x1, uint32_t x2,
                                         uint32_t x3, uint32_t mbar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], "
      "{%1, %2, %3, %4}, [%5];\n"
      :: "r"(dst), "r"(x0), "r"(x1), "r"(x2), "r"(x3), "r"(mbar)
      : "memory");
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(static_cast<uint32_t>(__cvta_generic_to_shared(bar))),
                  "r"(count) : "memory");
}
// one arrival that also expects `bytes` more bytes
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(static_cast<uint32_t>(__cvta_generic_to_shared(bar))),
                  "r"(bytes) : "memory");
}
// wait for the phase of this parity, acquiring what the peers' stores
// completed on it
__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar,
                                                  uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n"
      :: "r"(static_cast<uint32_t>(__cvta_generic_to_shared(bar))),
         "r"(parity) : "memory");
}
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// a peer's receive slot, in doubles: the record (score, then the lane and
// avail bit in the low word of the second double), then rows 0..w-1 of its
// candidate column, padded to 16 bytes
__host__ __device__ __forceinline__ int slot_doubles(int w) {
  return 2 + (w + 1) / 2 * 2;
}

// dynamic shared memory of a cluster CTA: two mbarriers, two receive areas
// (a slot per peer), two pivot columns, avail and the [w, lanes] slab with
// an odd row stride
size_t cluster_smem_bytes(int w, int lanes) {
  return 2 * sizeof(uint64_t) +
         ((size_t)2 * kMaxCluster * slot_doubles(w) + 2 * w + lanes +
          (size_t)w * (lanes | 1)) * sizeof(double);
}

// named barriers of the cluster kernel's two warp groups (0 is
// __syncthreads): the chain group's own, "the update of column c is done"
// and "the update of column c may start"
constexpr int kChain = 128;           // chain threads (warps 0-3); the rest update
constexpr int kBarChain = 1;
constexpr int kBarDone = 2;
constexpr int kBarStart = 3;

__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(count) : "memory");
}
// arrive without waiting; what this thread wrote to shared memory before
// is visible to the threads that wait on the barrier
__device__ __forceinline__ void bar_arrive(int id, int count) {
  __threadfence_block();
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(count) : "memory");
}

// Warp-specialised: the chain warps run each column's exchange, its
// multipliers, row c+1 and the candidate for c+1, while the update warps
// apply column c-1's update to rows c+2..w-1 (the bulk, which took 0.8 us
// a column on the H100, longer than the exchange it followed). Row r gets
// columns up to r-3 from the update warps and columns r-2 and r-1 from the
// chain warps (at column r-1), so the two groups never touch one row at
// once. The chain waits for column c-1's bulk only before it publishes the
// candidate for c+1 (whose column must hold it), and retires pivot c only
// then (the bulk of c-1 still updates that lane).
__global__ void __launch_bounds__(kThreads, 1) rank1_f64_cluster_kernel(
    Args a) {
  extern __shared__ uint64_t smem_raw[];
  __shared__ double red_s[kChain / 32];
  __shared__ int red_i[kChain / 32];

  const int w = a.w, m = a.m, L = a.lanes;
  const int G = gridDim.x;            // the cluster is the grid
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int lane0 = blockIdx.x * L;
  const int nl = min(L, m - lane0);  // >= 1: the host sizes the grid so

  const int slot = slot_doubles(w);
  uint64_t* mbar = smem_raw;                                // [2]
  double* recv = reinterpret_cast<double*>(smem_raw + 2);   // [2][16][slot]
  // [2][w]: column c's pivot column in pcol + (c & 1) * w; the buffer is
  // rewritten for column c + 2 only after column c's bulk is done
  double* pcol = recv + 2 * kMaxCluster * slot;
  double* avail_s = pcol + 2 * w;                           // [L]
  double* slab = avail_s + L;                               // [w][L | 1]
  const size_t ld = L | 1;
  // 16-byte words a peer sends for column c: the record, then the column
  // from the word that holds row c on; and the bytes a CTA receives
  auto col_words = [&](int c) { return 1 + (w + 1) / 2 - c / 2; };
  auto col_bytes = [&](int c) {
    return static_cast<uint32_t>(G * col_words(c) * 16);
  };

  if (tid == 0) {
    mbar_init(&mbar[0], 1);
    mbar_init(&mbar[1], 1);
    mbar_expect_tx(&mbar[0], col_bytes(0));
    if (w > 1) mbar_expect_tx(&mbar[1], col_bytes(1));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int r = 0; r < w; ++r)
    for (int i = tid; i < nl; i += kThreads)
      slab[r * ld + i] = a.mt_in[(size_t)r * m + lane0 + i];
  for (int i = tid; i < nl; i += kThreads) avail_s[i] = a.avail_in[lane0 + i];
  // every peer's mbarriers are armed before anyone sends
  cluster_sync();

  if (tid >= kChain) {
    // the update warps: column c's update of rows c+3..w-1 (rows c+1 and
    // c+2 get it from the chain), each thread's lanes in steps of 32, each
    // over its warp's rows, four rows' loads issued before their stores
    const int uw = warp - kChain / 32, nuw = (kThreads - kChain) / 32;
    for (int c = 0; c < w; ++c) {
      bar_sync(kBarStart, kThreads);
      const double* pc = pcol + (c & 1) * w;
      const double* row = slab + c * ld;
      for (int i = lane; i < nl; i += 32) {
        if (!(avail_s[i] > 0.0)) continue;
        const double mu = row[i];
        int r = c + 3 + uw;
        for (; r + 3 * nuw < w; r += 4 * nuw) {
          double* e[4];
          double x[4], pr[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            e[u] = slab + (r + u * nuw) * ld + i;
            x[u] = *e[u];
            pr[u] = pc[r + u * nuw];
          }
#pragma unroll
          for (int u = 0; u < 4; ++u) *e[u] = rank1(x[u], pr[u], mu);
        }
        for (; r < w; r += nuw) {
          double* e = slab + r * ld + i;
          *e = rank1(*e, pc[r], mu);
        }
      }
      bar_arrive(kBarDone, kThreads);
    }
  } else {
    // the chain warps
    // this thread's candidate among its lanes of row `row` for column c,
    // lane `skip` (the pivot not yet retired) left out
    auto local_best = [&](const double* row, int c, int skip, double& best,
                          int& bi) {
      const int fp = a.j0 + c;
      best = -INFINITY;
      bi = INT_MAX;
      for (int i = tid; i < nl; i += kChain) {
        const int gi = lane0 + i;
        double s;
        if (a.forced)
          s = gi == fp ? INFINITY : -INFINITY;
        else
          s = avail_s[i] > 0.0 && gi != skip ? fabs(row[i]) : -INFINITY;
        if (better(s, gi, best, bi)) {
          best = s;
          bi = gi;
        }
      }
      // the chain's candidate: every chain thread gets the same
      int unused = 0;
      warp_best(best, bi, unused);
      if (lane == 0) {
        red_s[warp] = best;
        red_i[warp] = bi;
      }
      bar_sync(kBarChain, kChain);
      best = red_s[lane % (kChain / 32)];
      bi = red_i[lane % (kChain / 32)];
      warp_best(best, bi, unused);
      best = __shfl_sync(0xffffffffu, best, 0);
      bi = __shfl_sync(0xffffffffu, bi, 0);
    };
    // push lane bi as this CTA's candidate for column c into every peer's
    // slot: each thread computes some 16-byte words and sends each to
    // every peer, completing its bytes on the peer's mbarrier. Rows past c
    // of the column still owe column c-1's update (its bulk has not
    // started), applied here as the bulk will apply it.
    auto publish = [&](int c, double best, int bi) {
      const int li = bi - lane0;
      const int buf = c & 1;
      const bool upd = c > 0 && avail_s[li] > 0.0;
      const double* prev = pcol + ((c - 1) & 1) * w;   // column c-1's pivot
      const double mu = upd ? slab[(size_t)(c - 1) * ld + li] : 0.0;
      const int n = col_words(c);
      const uint32_t rec1 =
          (static_cast<uint32_t>(bi) << 1) | (avail_s[li] > 0.0 ? 1u : 0u);
      double* mine = recv + (buf * kMaxCluster + blockIdx.x) * slot;
      for (int j = tid; j < n; j += kChain) {
        uint32_t v0, v1, v2, v3;
        int off;                     // the word's first double in the slot
        if (j == 0) {
          v0 = static_cast<uint32_t>(__double2loint(best));
          v1 = static_cast<uint32_t>(__double2hiint(best));
          v2 = rec1;
          v3 = 0;
          off = 0;
        } else {
          const int r0 = 2 * (c / 2 + j - 1);   // rows r0, r0 + 1
          double x[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int r = r0 + e;
            double y = 0.0;
            if (r >= c && r < w) {
              y = slab[r * ld + li];
              if (upd && r > c) y = rank1(y, prev[r], mu);
            }
            x[e] = y;
          }
          v0 = static_cast<uint32_t>(__double2loint(x[0]));
          v1 = static_cast<uint32_t>(__double2hiint(x[0]));
          v2 = static_cast<uint32_t>(__double2loint(x[1]));
          v3 = static_cast<uint32_t>(__double2hiint(x[1]));
          off = 2 + r0;
        }
        for (int g = 0; g < G; ++g)
          st_async(map_rank(mine + off, g), v0, v1, v2, v3,
                   map_rank(&mbar[buf], g));
      }
    };
    // the pivot lane of column c: every warp reduces the G records in the
    // same order, then the winner's column rows c..w-1 are copied into the
    // pivot column buffer
    auto exchange = [&](int c) {
      const int buf = c & 1;
      double* pc = pcol + buf * w;
      mbar_wait_cluster(&mbar[buf], (c >> 1) & 1);
      double s = -INFINITY;
      int i = INT_MAX, kc = 0;   // kc: the record's CTA and avail bit
      if (lane < G) {
        const double* rc = recv + (buf * kMaxCluster + lane) * slot;
        s = rc[0];
        const uint32_t r1 = static_cast<uint32_t>(__double2loint(rc[1]));
        i = static_cast<int>(r1 >> 1);
        kc = 2 * lane + static_cast<int>(r1 & 1u);
      }
      warp_best(s, i, kc);
      const int wc = __shfl_sync(0xffffffffu, kc, 0);
      const int wp = __shfl_sync(0xffffffffu, i, 0);
      if (blockIdx.x == 0 && tid == 0) {
        a.piv[c] = wp;
        a.ok[c] = wc & 1;
      }
      const double* src = recv + (buf * kMaxCluster + (wc >> 1)) * slot;
      for (int r = c + tid; r < w; r += kChain) pc[r] = src[2 + r];
      bar_sync(kBarChain, kChain);   // pc is whole; this receive area is read
      // arm it for column c + 2 (whose bytes may already be arriving)
      if (tid == 0 && c + 2 < w) mbar_expect_tx(&mbar[buf], col_bytes(c + 2));
      return wp;
    };

    {
      double best;
      int bi;
      local_best(slab, 0, -1, best, bi);
      publish(0, best, bi);
    }

    for (int c = 0; c < w; ++c) {
      const int p = exchange(c);
      const double* pc = pcol + (c & 1) * w;
      const double* prev = pcol + ((c - 1) & 1) * w;
      const double pv = pc[c];
      const double safe = pv == 0.0 ? 1.0 : pv;
      double* row = slab + c * ld;
      double* next = row + ld;
      const bool more = c + 1 < w;

      // 1. row c+1's update by column c-1 (pivot c still counts as
      // available: its lane took that column), the multipliers of column
      // c, and row c+1's update by column c
      for (int i = tid; i < nl; i += kChain) {
        if (!(avail_s[i] > 0.0)) continue;
        if (more && c > 0)
          next[i] = rank1(next[i], prev[c + 1], row[i - ld]);
        if (lane0 + i == p) continue;
        const double mu = __ddiv_rn(row[i], safe);
        row[i] = mu;
        if (more) next[i] = rank1(next[i], pc[c + 1], mu);
      }
      double best = -INFINITY;
      int bi = INT_MAX;
      if (more) local_best(next, c + 1, p, best, bi);
      // 2. column c-1's bulk is done: retire pivot c, then publish the
      // candidate for c+1 and let column c's bulk start
      if (c > 0) bar_sync(kBarDone, kThreads);
      if (p >= lane0 && p < lane0 + nl && tid == 0) avail_s[p - lane0] = 0.0;
      bar_sync(kBarChain, kChain);
      if (more) publish(c + 1, best, bi);
      bar_arrive(kBarStart, kThreads);
    }
    bar_sync(kBarDone, kThreads);    // the last column's bulk
  }
  __syncthreads();
  // no CTA leaves while a peer's stores into it may be in flight
  cluster_sync();

  for (int r = 0; r < w; ++r)
    for (int i = tid; i < nl; i += kThreads)
      a.mt_out[(size_t)r * m + lane0 + i] = slab[r * ld + i];
  for (int i = tid; i < nl; i += kThreads) a.avail_out[lane0 + i] = avail_s[i];
}

// --------------------------------------------------------------- grid route

// Publish this CTA's candidate record, one grid barrier, and every CTA
// reduces the records in the same order: returns the pivot lane of column
// jj and its value, with rows jj+1..w-1 of its column in pcol and piv /
// ok written. `column(cbuf)` writes the candidate lane's column rows
// jj..w-1 into cbuf, a row a thread. Each thread below G reads one
// record, all at once, and the CTA reduces them (red_s, red_i, red_c:
// kWarps each), so the winner costs one round trip to the L2.
template <typename Column>
__device__ __forceinline__ int grid_exchange(const Args& a, int jj, double best,
                                             int bi, double avail_li,
                                             double* pcol, double& pv,
                                             double* red_s, int* red_i,
                                             int* red_c, cg::grid_group& grid,
                                             Column column) {
  const int tid = threadIdx.x, G = gridDim.x, w = a.w;
  // publish it with its column values (rows jj..w-1), L2 only: the
  // records are rewritten every other column, and L1 is not coherent.
  // The lane index travels as a double (exact below 2^53).
  const int buf = jj & 1;
  double* head = a.head + ((size_t)buf * G + blockIdx.x) * kHead;
  double* cbuf = a.cols + ((size_t)buf * G + blockIdx.x) * w;
  column(cbuf);
  if (tid == 0) {
    __stcg(head + 0, best);
    __stcg(head + 1, static_cast<double>(bi));
    __stcg(head + 2, avail_li);
  }
  // one barrier per column. Double-buffered records are safe: a CTA
  // rewrites buffer `buf` only after the next barrier, which every CTA
  // reaches only after it has read this column's records.
  if (G > 1)
    grid.sync();
  else
    __syncthreads();
  // c: the record's CTA and its lane's avail bit
  double s = -INFINITY;
  int i = INT_MAX, c = 0;
  for (int k = tid; k < G; k += kThreads) {
    const double* h = a.head + ((size_t)buf * G + k) * kHead;
    const double ks = __ldcg(h);
    const int ki = static_cast<int>(__ldcg(h + 1));
    const int kc = 2 * k + (__ldcg(h + 2) > 0.0 ? 1 : 0);
    if (better(ks, ki, s, i)) {
      s = ks;
      i = ki;
      c = kc;
    }
  }
  const int lane = tid & 31, warp = tid >> 5;
  warp_best(s, i, c);
  if (lane == 0) {
    red_s[warp] = s;
    red_i[warp] = i;
    red_c[warp] = c;
  }
  __syncthreads();
  s = red_s[lane % kWarps];
  i = red_i[lane % kWarps];
  c = red_c[lane % kWarps];
  warp_best(s, i, c);
  const int p = __shfl_sync(0xffffffffu, i, 0);
  c = __shfl_sync(0xffffffffu, c, 0);
  const double* wcol = a.cols + ((size_t)buf * G + (c >> 1)) * w;
  pv = __ldcg(wcol + jj);
  for (int r = jj + 1 + tid; r < w; r += kThreads) pcol[r] = __ldcg(wcol + r);
  if (blockIdx.x == 0 && tid == 0) {
    a.piv[jj] = p;
    a.ok[jj] = c & 1;
  }
  __syncthreads();
  return p;
}

// On-chip grid route, one lane per thread (a.lanes <= kThreads): rows
// 0..Rs-1 of the CTA's lanes in shared memory with an odd row stride, the
// last kRR rows (the fewest of 0, 16 and 32 that let the rest fit) in the
// registers of the lane's thread: xr[q] holds row Rs + q, and every index
// into xr is a compile-time constant. The register rows are updated
// without branches (each row's new value selected by its row index), and
// the candidate's register rows reach the exchange through shared memory
// (one thread writes them, the CTA publishes them with the rest), since
// both the branchy update and one thread's stores to the L2 lengthened
// every column by about a microsecond on the H100.
size_t grid_smem_bytes(int w, int lanes, int reg_rows) {
  return ((size_t)(w - reg_rows) * (lanes | 1) + lanes + w) * sizeof(double);
}

template <int kRR>
__global__ void __launch_bounds__(kThreads, 1) rank1_f64_grid_kernel(Args a) {
  extern __shared__ double smem[];
  __shared__ double red_s[kWarps];
  __shared__ int red_i[kWarps], red_c[kWarps];
  __shared__ double stage[kRR > 0 ? kRR : 1];  // the candidate's register rows

  const int w = a.w, m = a.m, L = a.lanes;
  const int tid = threadIdx.x;
  const int lane0 = blockIdx.x * L;
  const int nl = min(L, m - lane0);  // >= 1: the host sizes the grid so
  const int Rs = w - kRR;            // rows in shared memory
  const size_t ld = L | 1;
  double* S = smem;                          // [Rs][ld]
  double* avail_s = smem + (size_t)Rs * ld;  // [L]
  double* pcol = avail_s + L;                // [w] the pivot lane's column
  const bool mine = tid < nl;                // thread tid holds lane tid
  const int gi = lane0 + tid;
  double xr[kRR > 0 ? kRR : 1];

  for (int r = 0; r < Rs; ++r)
    for (int i = tid; i < nl; i += kThreads)
      S[r * ld + i] = a.mt_in[(size_t)r * m + lane0 + i];
  if (mine) {
#pragma unroll
    for (int q = 0; q < kRR; ++q) xr[q] = a.mt_in[(size_t)(Rs + q) * m + gi];
    avail_s[tid] = a.avail_in[gi];
  }
  __syncthreads();

  cg::grid_group grid = cg::this_grid();

  for (int jj = 0; jj < w; ++jj) {
    // 1. this CTA's candidate: masked |x| argmax over its lanes of row jj
    double xj = 0.0;
    if (mine) {
      if (jj < Rs) {
        xj = S[jj * ld + tid];
      } else {
#pragma unroll
        for (int q = 0; q < kRR; ++q)
          if (Rs + q == jj) xj = xr[q];
      }
    }
    double best = -INFINITY;
    int bi = INT_MAX;
    if (mine) {
      best = a.forced ? (gi == a.j0 + jj ? INFINITY : -INFINITY)
                      : (avail_s[tid] > 0.0 ? fabs(xj) : -INFINITY);
      bi = gi;
    }
    cta_best(best, bi, red_s, red_i);
    const int li = bi - lane0;
    if (kRR > 0) {
      if (tid == li) {
#pragma unroll
        for (int q = 0; q < kRR; ++q) stage[q] = xr[q];
      }
      __syncthreads();
    }

    // 2. the exchange: rows jj..w-1 of lane li, a row a thread
    double pv;
    const int p = grid_exchange(
        a, jj, best, bi, avail_s[li], pcol, pv, red_s, red_i, red_c, grid,
        [&](double* cbuf) {
          for (int r = jj + tid; r < w; r += kThreads)
            __stcg(cbuf + r, r < Rs ? S[r * ld + li] : stage[r - Rs]);
        });

    // 3. rank-1 update of this thread's lane, if it is available and not
    // the pivot; four shared rows' loads issued before their stores
    if (mine) {
      if (gi == p) {
        avail_s[tid] = 0.0;
      } else if (avail_s[tid] > 0.0) {
        const double mu = __ddiv_rn(xj, pv == 0.0 ? 1.0 : pv);
        if (jj < Rs) S[jj * ld + tid] = mu;
        int r = jj + 1;
        for (; r + 3 < Rs; r += 4) {
          double x[4], pr[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            x[u] = S[(r + u) * ld + tid];
            pr[u] = pcol[r + u];
          }
#pragma unroll
          for (int u = 0; u < 4; ++u)
            S[(r + u) * ld + tid] = rank1(x[u], pr[u], mu);
        }
        for (; r < Rs; ++r)
          S[r * ld + tid] = rank1(S[r * ld + tid], pcol[r], mu);
        // every register row's update computed (pcol's rows up to jj are
        // stale, and their results dropped), then each row's value
        // selected: no branch between the loads and the arithmetic
        double pr[kRR > 0 ? kRR : 1];
#pragma unroll
        for (int q = 0; q < kRR; ++q) pr[q] = pcol[Rs + q];
#pragma unroll
        for (int q = 0; q < kRR; ++q) {
          const double y = rank1(xr[q], pr[q], mu);
          xr[q] = Rs + q > jj ? y : Rs + q == jj ? mu : xr[q];
        }
      }
    }
    // the next column's cta_best holds the barrier that orders these
    // updates before its publish reads them
  }

  for (int r = 0; r < Rs; ++r)
    for (int i = tid; i < nl; i += kThreads)
      a.mt_out[(size_t)r * m + lane0 + i] = S[r * ld + i];
  if (mine) {
#pragma unroll
    for (int q = 0; q < kRR; ++q) a.mt_out[(size_t)(Rs + q) * m + gi] = xr[q];
    a.avail_out[gi] = avail_s[tid];
  }
}

// Global-slab grid route, for blocks the on-chip route cannot hold (more
// than kThreads lanes a CTA): each CTA works on its lanes of the output in
// global memory, several lanes a thread.
__global__ void __launch_bounds__(kThreads, 1) rank1_f64_grid_global_kernel(
    Args a) {
  extern __shared__ double smem[];
  __shared__ double red_s[kWarps];
  __shared__ int red_i[kWarps], red_c[kWarps];

  const int w = a.w, m = a.m, L = a.lanes;
  const int tid = threadIdx.x;
  const int lane0 = blockIdx.x * L;
  const int nl = min(L, m - lane0);
  double* slab = a.mt_out + lane0;
  const size_t ld = m;
  double* avail_s = smem;       // [L]
  double* pcol = avail_s + L;   // [w]

  for (int r = 0; r < w; ++r)
    for (int i = tid; i < nl; i += kThreads)
      slab[r * ld + i] = a.mt_in[(size_t)r * m + lane0 + i];
  for (int i = tid; i < nl; i += kThreads) avail_s[i] = a.avail_in[lane0 + i];
  __syncthreads();

  cg::grid_group grid = cg::this_grid();

  for (int jj = 0; jj < w; ++jj) {
    double* row = slab + jj * ld;
    const int fp = a.j0 + jj;
    double best = -INFINITY;
    int bi = INT_MAX;
    for (int i = tid; i < nl; i += kThreads) {
      const int gi = lane0 + i;
      const double s = a.forced ? (gi == fp ? INFINITY : -INFINITY)
                                : (avail_s[i] > 0.0 ? fabs(row[i]) : -INFINITY);
      if (better(s, gi, best, bi)) {
        best = s;
        bi = gi;
      }
    }
    cta_best(best, bi, red_s, red_i);
    const int li = bi - lane0;
    double pv;
    const int p = grid_exchange(
        a, jj, best, bi, avail_s[li], pcol, pv, red_s, red_i, red_c, grid,
        [&](double* cbuf) {
          for (int r = jj + tid; r < w; r += kThreads)
            __stcg(cbuf + r, slab[r * ld + li]);
        });

    const double safe = pv == 0.0 ? 1.0 : pv;
    for (int i = tid; i < nl; i += kThreads) {
      if (lane0 + i == p) {
        avail_s[i] = 0.0;
        continue;
      }
      if (!(avail_s[i] > 0.0)) continue;
      const double mu = __ddiv_rn(row[i], safe);
      row[i] = mu;
      int r = jj + 1;
      for (; r + 3 < w; r += 4) {
        double x[4], pr[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          x[u] = slab[(r + u) * ld + i];
          pr[u] = pcol[r + u];
        }
#pragma unroll
        for (int u = 0; u < 4; ++u)
          slab[(r + u) * ld + i] = rank1(x[u], pr[u], mu);
      }
      for (; r < w; ++r) slab[r * ld + i] = rank1(slab[r * ld + i], pcol[r], mu);
    }
    // the next column's cta_best orders these updates before its reads
  }
  __syncthreads();
  for (int i = tid; i < nl; i += kThreads) a.avail_out[lane0 + i] = avail_s[i];
}

int ceil_div(int a, int b) { return (a + b - 1) / b; }

// what a device offers the kernel, found once per process and device
struct DeviceInfo {
  cudaError_t err;
  int sms;
  size_t smem;       // dynamic shared memory a CTA may take
  int cluster;       // largest cluster the cluster kernel is granted (<= 16)
};
DeviceInfo g_info[kMaxDevices];
std::once_flag g_once[kMaxDevices];

cudaError_t init_device(int dev, DeviceInfo& d) {
  cudaError_t e = cudaDeviceGetAttribute(&d.sms, cudaDevAttrMultiProcessorCount,
                                         dev);
  if (e != cudaSuccess) return e;
  int optin = 0;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev);
  if (e != cudaSuccess) return e;
  d.smem = (size_t)optin - 1024;   // the kernels' static shared memory
  const void* fns[] = {
      reinterpret_cast<const void*>(&rank1_f64_cluster_kernel),
      reinterpret_cast<const void*>(&rank1_f64_tile_kernel),
      reinterpret_cast<const void*>(&rank1_f64_grid_kernel<0>),
      reinterpret_cast<const void*>(&rank1_f64_grid_kernel<kRegRows / 2>),
      reinterpret_cast<const void*>(&rank1_f64_grid_kernel<kRegRows>),
      reinterpret_cast<const void*>(&rank1_f64_grid_global_kernel)};
  for (const void* fn : fns) {
    e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(d.smem));
    if (e != cudaSuccess) return e;
  }
  e = cudaFuncSetAttribute(fns[0],
                           cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return e;
  // the largest cluster granted with the shared memory its widest CTA
  // (kClusterLanes lanes at w = 128) takes
  const size_t need = cluster_smem_bytes(128, kClusterLanes);
  d.cluster = 0;
  for (int c = kMaxCluster; c >= 1 && d.cluster == 0; c /= 2) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(c);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = need;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = c;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int n = 0;
    e = cudaOccupancyMaxActiveClusters(&n, rank1_f64_cluster_kernel, &cfg);
    if (e != cudaSuccess) {
      cudaGetLastError();   // a refused size is an answer, not a fault
      continue;
    }
    if (n >= 1) d.cluster = c;
  }
  return d.cluster == 0 ? cudaErrorNotSupported : cudaSuccess;
}

const DeviceInfo* device_info(cudaError_t& e) {
  int dev = 0;
  e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return nullptr;
  if (dev < 0 || dev >= kMaxDevices) {
    e = cudaErrorInvalidDevice;
    return nullptr;
  }
  std::call_once(g_once[dev],
                 [&] { g_info[dev].err = init_device(dev, g_info[dev]); });
  e = g_info[dev].err;
  return e == cudaSuccess ? &g_info[dev] : nullptr;
}

// the widest block the cluster route takes at width w: kClusterLanes lanes
// per CTA of the granted cluster, fewer where w is so wide that the slab
// would not fit
int cluster_max_m(const DeviceInfo& d, int w) {
  int lanes = kClusterLanes;
  while (lanes > 0 && cluster_smem_bytes(w, lanes) > d.smem) lanes -= 32;
  return lanes * d.cluster;
}

// the route of a [w, m] block, from (w, m) and the mode alone
Route route_for(const DeviceInfo& d, int w, int m, bool forced) {
  if (forced && w <= kTileMaxW &&
      tile_smem_bytes(w, kTileLanes + w) <= d.smem)
    return kRouteTile;
  return m <= cluster_max_m(d, w) ? kRouteCluster : kRouteGrid;
}

}  // namespace

extern "C" {

// doubles of scratch the wrapper allocates for a block of width w (the
// grid route's candidate records and columns)
int conflux_rank1_panel_f64_scratch_doubles(int w) {
  return 2 * kMaxGrid * (kHead + w);
}

// the largest m the cluster route takes at width w on the current device
// (0 if the device cannot be queried)
int conflux_rank1_panel_f64_cluster_max_m(int w) {
  cudaError_t e;
  const DeviceInfo* d = device_info(e);
  return d ? cluster_max_m(*d, w) : 0;
}

// the route conflux_rank1_panel_f64 takes for a [w, m] block (1 cluster,
// 2 grid, 3 tile; 0 if the device cannot be queried)
int conflux_rank1_panel_f64_route(int w, int m, int forced) {
  cudaError_t e;
  const DeviceInfo* d = device_info(e);
  return d ? route_for(*d, w, m, forced != 0) : 0;
}

const char* conflux_rank1_panel_f64_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Launch K1 in double on `stream`. *route receives the route taken (1
// cluster, 2 grid, 3 tile), chosen from (w, m) and the mode alone. Returns
// 0 or a cudaError_t code (a refused launch included); never synchronises.
int conflux_rank1_panel_f64(const double* mt_in, const double* avail_in,
                            double* mt_out, double* avail_out, int* piv,
                            int* ok, double* scratch, int w, int m,
                            int forced, int j0, void* stream, int* route) {
  if (w < 1 || m < 1 || m > 65536) return cudaErrorInvalidValue;
  cudaError_t e;
  const DeviceInfo* d = device_info(e);
  if (d == nullptr) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Route r = route_for(*d, w, m, forced != 0);
  *route = r;
  Args args{mt_in, avail_in, mt_out, avail_out, piv, ok,
            scratch, scratch + 2 * kMaxGrid * kHead, w, m, 0, forced, j0};

  if (r == kRouteTile) {
    args.lanes = kTileLanes;
    rank1_f64_tile_kernel<<<ceil_div(m, kTileLanes), kThreads,
                            tile_smem_bytes(w, kTileLanes + w), s>>>(args);
    return cudaGetLastError();
  }
  if (r == kRouteCluster) {
    int c = d->cluster;
    while (c > 1 && (c / 2) * kMinClusterLanes >= m) c /= 2;
    args.lanes = ceil_div(m, c);
    const int G = ceil_div(m, args.lanes);   // <= c
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(G);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = cluster_smem_bytes(w, args.lanes);
    cfg.stream = s;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = G;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    e = cudaLaunchKernelEx(&cfg, rank1_f64_cluster_kernel, args);
    if (e != cudaSuccess) return e;
    return cudaGetLastError();
  }

  // grid route: at most one CTA per SM, so the grid is always co-resident;
  // every SM takes lanes (down to kMinGridLanes each), and the slab stays
  // on chip where each CTA's lanes fit one to a thread, with the fewest
  // register rows that let the rest fit in shared memory
  const int g0 = std::min(std::min(d->sms, kMaxGrid),
                          ceil_div(m, kMinGridLanes));
  args.lanes = ceil_div(m, g0);
  int rr = 0;
  while (rr < kRegRows && rr < w &&
         grid_smem_bytes(w, args.lanes, rr) > d->smem)
    rr += kRegRows / 2;
  size_t smem = grid_smem_bytes(w, args.lanes, std::min(rr, w));
  void* fn;
  if (args.lanes <= kThreads && rr < w && smem <= d->smem) {
    fn = rr == 0 ? reinterpret_cast<void*>(&rank1_f64_grid_kernel<0>)
         : rr == kRegRows / 2
             ? reinterpret_cast<void*>(&rank1_f64_grid_kernel<kRegRows / 2>)
             : reinterpret_cast<void*>(&rank1_f64_grid_kernel<kRegRows>);
  } else {
    const int g1 = std::min(std::min(d->sms, kMaxGrid),
                            ceil_div(m, kGlobalLanes));
    args.lanes = ceil_div(m, g1);
    smem = ((size_t)args.lanes + w) * sizeof(double);
    if (smem > d->smem) return cudaErrorInvalidValue;
    fn = reinterpret_cast<void*>(&rank1_f64_grid_global_kernel);
  }
  const int G = ceil_div(m, args.lanes);
  void* params[] = {&args};
  e = cudaLaunchCooperativeKernel(fn, dim3(G), dim3(kThreads), params, smem, s);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // extern "C"
