// K1: masked-argmax partial-pivoting rank-1 elimination of a transposed
// panel block, by hand for Hopper (sm_90a).
//
// Replaces the TPU kernel conflux_tpu/ops/pallas_panel.py:_rank1_kernel
// (wrapper rank1_block_pallas_t). Same inputs and outputs:
//   Mt [w, m] f32 (panel columns as rows, matrix rows as lanes),
//   avail [1, m] f32 (> 0 = selectable)
//   -> Mt' [w, m], avail' [1, m], piv [w] i32, ok [w] i32.
// For each column jj in order: pick the available lane p of largest |Mt[jj]|
// (lowest lane on ties, NaN ranks highest, as jnp.argmax), or p = j0 + jj
// in forced mode; store col / pivot (a true division; a zero pivot divides
// by 1) as the multipliers of the other available lanes in row jj; update
// rows jj+1..w-1 of those lanes by the rank-1 product; retire lane p.
//
// The TPU kernel's two-level structure (32-wide micro-panels plus a
// deferred one-hot GEMM update per boundary) exists to move VPU work onto
// the TPU's matrix unit. It is not carried over: this is the straight
// right-looking elimination, mathematically the same. Once a lane is
// retired its multiplier is 0, so pivot lanes keep the merged-factor values
// they held when selected; that is exactly what forced and finish modes ask
// for, so all three modes run the same code. (In unforced mode the TPU
// kernel leaves pivot lanes of later rows stale and no caller reads them.)
// Each update is the rank-1 step's own formula, x - pivcol * mult, with the
// product rounded before the subtraction (no fused multiply-add), and the
// multiplier is a true division.
//
// What bounds it on the H100: latency. Each column's pivot search spans
// every lane of the block and the next column depends on it, so the w
// columns form a chain of exchanges between the CTAs that hold the lanes
// (the bytes, 16 MiB at the main path's [128, 32768], would take 10 us).
// Each CTA keeps its [w, lanes] slab in shared memory for the whole call.
// Three routes, chosen from (w, m) and the mode alone:
//   * tile route, for forced blocks up to w = 128 (the pivot-row refactor
//     of flat, swap and split, every Cholesky diagonal tile): the pivots
//     are known, so each CTA eliminates its own lanes together with a copy
//     of the w pivot lanes and never waits for another CTA;
//   * cluster route, for other blocks of at most 16 x kClusterLanes lanes
//     (the last panels): one thread-block cluster. Each CTA pushes its candidate record and column into every
//     peer's shared memory with st.async, which completes bytes on the
//     peer's mbarrier (one per column parity, armed with the bytes that
//     column brings); every CTA waits on its own mbarrier, reduces the
//     records and copies the winner's column from its own shared memory.
//     No cluster barrier per column (its release fence compiles to a
//     GPU-wide memory barrier) and no global memory between the load and
//     the store. A receive area is re-armed only after it has been read,
//     and a peer writes it again only two columns later, after this CTA's
//     candidate for the column between has reached it. Lookahead: once
//     pivot jj is known, a CTA updates row jj+1 first, picks and pushes
//     its candidate for column jj+1 (that lane's column computed on the
//     spot), and only then applies the rest of column jj's update, which
//     so overlaps the exchange;
//   * grid route, for wider blocks: one persistent launch, one CTA per SM.
//     Where the card holds enough thread-block clusters of 8 CTAs at once
//     (15 on an H100: 120 CTAs, 274 lanes each at m = 32768), the CTAs run
//     in clusters and a column's exchange takes two levels: each CTA pushes
//     its candidate record and column into its cluster leader's shared
//     memory (st.async, as on the cluster route); the leader reduces them
//     and stores the cluster's winner in its slot in the L2 with the
//     column's tag in every 16-byte word (no fence, no flag, no grid
//     barrier); every CTA reads the <= 16 slots until the tags are the
//     column's. The warps split: four run this chain (the exchange, the
//     multipliers, row jj+1 and the candidate for jj+1), four apply the
//     rest of column jj's update meanwhile. Candidates reduce as one 64-bit
//     key by warp redux. Blocks wider than the clustered slabs hold
//     (m > ~47k at w = 128), and cards that hold no such clusters, take the
//     flat exchange: one cooperative launch, each CTA publishing its
//     candidate with that lane's column values, one grid barrier a column;
//     past ~59k lanes at w = 128 it works on the output in global memory,
//     which the 50 MB L2 holds. Tried and slower at [128, 32768] on the H100
//     (experiments/torch_kernel_ab.py, PERF.md): on the flat exchange, a
//     tagged exchange (every CTA polling every CTA's record), a split
//     arrival count with the lookahead in place of the grid barrier, and 512
//     threads per CTA with two threads per lane in the update; on the
//     clustered one, the leaders pushing the pivot back into their clusters
//     (one more hop than every CTA reading the slots), two CTAs an SM in
//     clusters of 16 or of 8, 160 to 256 chain threads, 256 update threads,
//     and update warps that split the rows rather than the lanes.
// Every CTA reduces the candidates in the same order, so all agree on the
// pivot with no second exchange. No tensor cores: each column's update is
// rank-1 and depends on the previous column's pivot.

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
constexpr int kMaxCluster = 16;         // non-portable cluster size
constexpr int kClusterLanes = 128;      // lanes a cluster CTA holds, at most
constexpr int kMinClusterLanes = 64;    // ... and, where m allows, at least
constexpr int kLanesPerCta = 256;       // lanes a grid-route CTA aims to own
constexpr int kMaxGrid = 1024;          // bound of the grid scratch layout
constexpr int kHead = 4;                // score, lane, avail[lane], pad
constexpr int kMaxDevices = 64;

enum Route { kRouteCluster = 1, kRouteGrid = 2, kRouteTile = 3 };

// argmax order: larger score wins, NaN beats any number, lower lane on ties
__device__ __forceinline__ bool better(float a, int ia, float b, int ib) {
  const bool na = isnan(a), nb = isnan(b);
  if (na || nb) return na && (!nb || ia < ib);
  return a > b || (a == b && ia < ib);
}

__device__ __forceinline__ void warp_best(float& s, int& i, int& c) {
  for (int off = 16; off > 0; off >>= 1) {
    const float os = __shfl_down_sync(0xffffffffu, s, off);
    const int oi = __shfl_down_sync(0xffffffffu, i, off);
    const int oc = __shfl_down_sync(0xffffffffu, c, off);
    if (better(os, oi, s, i)) {
      s = os;
      i = oi;
      c = oc;
    }
  }
}

// ------------------------------------------------------------ cluster route

// cluster route: this CTA's shared address `p` as seen from CTA `rank`
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
__device__ __forceinline__ void st_async(uint32_t dst, float4 v,
                                         uint32_t mbar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], "
      "{%1, %2, %3, %4}, [%5];\n"
      :: "r"(dst), "r"(__float_as_uint(v.x)), "r"(__float_as_uint(v.y)),
         "r"(__float_as_uint(v.z)), "r"(__float_as_uint(v.w)), "r"(mbar)
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

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// a peer's receive slot, in floats: 4 words (score, lane and avail, 2
// unused), then rows 0..w-1 of its candidate column, padded to 16 bytes
__host__ __device__ __forceinline__ int slot_floats(int w) {
  return 4 + (w + 3) / 4 * 4;
}

// dynamic shared memory of a cluster CTA: two mbarriers, two receive areas
// (a slot per peer), two pivot columns, avail and the [w, lanes] slab with
// an odd row stride
size_t cluster_smem_bytes(int w, int lanes) {
  return 2 * sizeof(uint64_t) +
         ((size_t)2 * kMaxCluster * slot_floats(w) + 2 * w + lanes +
          (size_t)w * (lanes | 1)) * sizeof(float);
}

struct ClusterArgs {
  const float* mt_in;
  const float* avail_in;
  float* mt_out;
  float* avail_out;
  int* piv;
  int* ok;
  int w, m, lanes, forced, j0;
};

__global__ void __launch_bounds__(kThreads, 1) rank1_cluster_kernel(
    ClusterArgs a) {
  extern __shared__ uint64_t smem_raw[];
  __shared__ float red_s[kWarps];
  __shared__ int red_i[kWarps];

  const int w = a.w, m = a.m, L = a.lanes;
  const int G = gridDim.x;            // the cluster is the grid
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int lane0 = blockIdx.x * L;
  const int nl = min(L, m - lane0);  // >= 1: the host sizes the grid so

  const int slot = slot_floats(w);
  uint64_t* mbar = smem_raw;                                // [2]
  float* recv = reinterpret_cast<float*>(smem_raw + 2);     // [2][16][slot]
  // [2][w]: column c's pivot column in pcol + (c & 1) * w, so column c's
  // copy never overwrites the one the rest of column c-1's update reads
  float* pcol = recv + 2 * kMaxCluster * slot;
  float* avail_s = pcol + 2 * w;                            // [L]
  // the slab holds this CTA's [w, nl] lanes with an odd row stride: a
  // column's rows fall in distinct banks
  float* slab = avail_s + L;
  const size_t ld = L | 1;
  // 16-byte words a peer sends for column c: the record, then the column
  // from the word that holds row c on; and the bytes a CTA receives
  auto col_words = [&](int c) { return 1 + (w + 3) / 4 - c / 4; };
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
  cluster_arrive();
  cluster_wait();

  // this thread's candidate among its lanes of row `row` for column c
  auto local_best = [&](const float* row, int c, float& best, int& bi) {
    const int fp = a.j0 + c;
    best = -INFINITY;
    bi = INT_MAX;
    for (int i = tid; i < nl; i += kThreads) {
      const int gi = lane0 + i;
      float s;
      if (a.forced)
        s = gi == fp ? INFINITY : -INFINITY;
      else
        s = avail_s[i] > 0.f ? fabsf(row[i]) : -INFINITY;
      if (better(s, gi, best, bi)) {
        best = s;
        bi = gi;
      }
    }
    int unused = 0;
    warp_best(best, bi, unused);
    if (lane == 0) {
      red_s[warp] = best;
      red_i[warp] = bi;
    }
  };
  // after a barrier: this CTA's candidate, reduced from the warps' (every
  // thread the same; a real lane of this CTA: nl >= 1 and -inf ties go low)
  auto cta_best = [&](float& best, int& bi) {
    best = red_s[lane % kWarps];
    bi = red_i[lane % kWarps];
    int unused = 0;
    warp_best(best, bi, unused);
    best = __shfl_sync(0xffffffffu, best, 0);
    bi = __shfl_sync(0xffffffffu, bi, 0);
  };
  // push lane bi as this CTA's candidate for column c into every peer's
  // slot: each thread sends some 16-byte words, each completing its bytes
  // on the peer's mbarrier. Rows past c of the column still owe column
  // c-1's update, applied here as the rest of the update will apply it.
  auto publish = [&](int c, float best, int bi) {
    const int li = bi - lane0;
    const int buf = c & 1;
    const bool upd = c > 0 && avail_s[li] > 0.f;
    const float* prev = pcol + ((c - 1) & 1) * w;      // column c-1's pivot
    const float mu = upd ? slab[(size_t)(c - 1) * ld + li] : 0.f;
    const int n = col_words(c);
    const uint32_t rec1 =
        (static_cast<uint32_t>(bi) << 1) | (avail_s[li] > 0.f ? 1u : 0u);
    float* mine = recv + (buf * kMaxCluster + blockIdx.x) * slot;
    for (int q = tid; q < G * n; q += kThreads) {
      const int g = q / n, j = q % n;
      float4 v;
      int off;                       // the word's first float in the slot
      if (j == 0) {
        v = make_float4(best, __uint_as_float(rec1), 0.f, 0.f);
        off = 0;
      } else {
        const int r0 = 4 * (c / 4 + j - 1);   // rows r0..r0+3
        float x[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = r0 + e;
          float y = 0.f;
          if (r >= c && r < w) {
            y = slab[r * ld + li];
            if (upd && r > c) y = __fsub_rn(y, __fmul_rn(prev[r], mu));
          }
          x[e] = y;
        }
        v = make_float4(x[0], x[1], x[2], x[3]);
        off = 4 + r0;
      }
      st_async(map_rank(mine + off, g), v, map_rank(&mbar[buf], g));
    }
  };
  // the pivot lane of column c: every warp reduces the G records in the
  // same order, then the winner's column rows c..w-1 are copied into the
  // pivot column buffer
  auto exchange = [&](int c) {
    const int buf = c & 1;
    float* pc = pcol + buf * w;
    mbar_wait_cluster(&mbar[buf], (c >> 1) & 1);
    float s = -INFINITY;
    int i = INT_MAX, kc = 0;   // kc: the record's CTA and avail bit
    if (lane < G) {
      const float* rc = recv + (buf * kMaxCluster + lane) * slot;
      s = rc[0];
      const uint32_t r1 = __float_as_uint(rc[1]);
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
    const float* src = recv + (buf * kMaxCluster + (wc >> 1)) * slot;
    for (int r = c + tid; r < w; r += kThreads) pc[r] = src[4 + r];
    __syncthreads();   // pc is whole; this receive area is read
    // arm it for column c + 2 (whose bytes may already be arriving)
    if (tid == 0 && c + 2 < w) mbar_expect_tx(&mbar[buf], col_bytes(c + 2));
    return wp;
  };

  {
    float best;
    int bi;
    local_best(slab, 0, best, bi);
    __syncthreads();
    cta_best(best, bi);
    publish(0, best, bi);
  }

  for (int jj = 0; jj < w; ++jj) {
    const int p = exchange(jj);
    const float* pc = pcol + (jj & 1) * w;
    const float pv = pc[jj];
    const float safe = pv == 0.f ? 1.f : pv;
    float* row = slab + jj * ld;
    float* next = row + ld;
    const bool more = jj + 1 < w;

    // 1. multipliers of this CTA's available, non-pivot lanes, row jj+1's
    // update, and this CTA's candidate for column jj+1 (each thread
    // searches the lanes it has just updated and retired)
    float best = -INFINITY;
    int bi = INT_MAX;
    for (int i = tid; i < nl; i += kThreads) {
      if (lane0 + i == p) {
        avail_s[i] = 0.f;
        continue;
      }
      if (!(avail_s[i] > 0.f)) continue;
      const float mu = __fdiv_rn(row[i], safe);
      row[i] = mu;
      if (more) next[i] = __fsub_rn(next[i], __fmul_rn(pc[jj + 1], mu));
    }
    if (more) local_best(next, jj + 1, best, bi);
    __syncthreads();
    if (more) {
      cta_best(best, bi);
      publish(jj + 1, best, bi);
    }
    // the candidate's column was read from the slab before the rest of
    // the update changes it
    __syncthreads();

    // 2. the rest of column jj's update, rows jj+2..w-1, every updated
    // lane: each thread's lanes in steps of 32, each over the warp's rows,
    // four rows' loads issued before their stores
    for (int i = lane; i < nl; i += 32) {
      if (!(avail_s[i] > 0.f)) continue;
      const float mu = row[i];
      int r = jj + 2 + warp;
      for (; r + 3 * kWarps < w; r += 4 * kWarps) {
        float* e[4];
        float x[4], pr[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          e[u] = slab + (r + u * kWarps) * ld + i;
          x[u] = *e[u];
          pr[u] = pc[r + u * kWarps];
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) *e[u] = __fsub_rn(x[u], __fmul_rn(pr[u], mu));
      }
      for (; r < w; r += kWarps) {
        float* e = slab + r * ld + i;
        *e = __fsub_rn(*e, __fmul_rn(pc[r], mu));
      }
    }
  }
  // no CTA leaves while a peer's stores into it may be in flight
  cluster_arrive();
  cluster_wait();

  for (int r = 0; r < w; ++r)
    for (int i = tid; i < nl; i += kThreads)
      a.mt_out[(size_t)r * m + lane0 + i] = slab[r * ld + i];
  for (int i = tid; i < nl; i += kThreads) a.avail_out[lane0 + i] = avail_s[i];
}

// --------------------------------------------------------------- tile route

// Forced blocks (w <= kTileMaxW): the pivots are known in advance, lane
// j0 + jj for column jj, so no CTA need wait for another. Each CTA holds
// its own kTileLanes lanes and a copy of the w pivot lanes (the tile) and
// eliminates them all together; column jj's pivot column is the tile's
// lane jj after the columns before it, in the CTA's own shared memory.
// Each lane's updates are the same operations in the same order as on the
// other routes, so a tile lane and its owner's copy agree bit for bit.
// One barrier per column, nothing else between the CTAs.
constexpr int kTileLanes = 128;
constexpr int kTileMaxW = 128;

// dynamic shared memory of a tile CTA: avail and the [w, nt] slab of its
// nt = lanes + w lanes with an odd row stride
size_t tile_smem_bytes(int w, int nt) {
  return ((size_t)nt + (size_t)w * (nt | 1)) * sizeof(float);
}

__global__ void __launch_bounds__(kThreads, 1) rank1_tile_kernel(
    ClusterArgs a) {
  extern __shared__ float tile_smem[];
  const int w = a.w, m = a.m, j0 = a.j0;
  const int tid = threadIdx.x;
  const int lane0 = blockIdx.x * kTileLanes;
  const int nl = min(kTileLanes, m - lane0);
  const int nt = nl + w;               // own lanes, then the tile's
  const size_t ld = nt | 1;
  float* av = tile_smem;               // [nt]
  float* S = tile_smem + nt;           // [w][ld]
  // slab lane i: own lane lane0 + i (i < nl), or tile lane j0 + i - nl
  auto global_lane = [&](int i) { return i < nl ? lane0 + i : j0 + i - nl; };
  for (int r = 0; r < w; ++r)
    for (int i = tid; i < nt; i += kThreads)
      S[r * ld + i] = a.mt_in[(size_t)r * m + global_lane(i)];
  for (int i = tid; i < nt; i += kThreads) av[i] = a.avail_in[global_lane(i)];
  __syncthreads();

  for (int jj = 0; jj < w; ++jj) {
    const float* pc = S + nl + jj;     // the pivot lane's column, stride ld
    const float pv = pc[jj * ld];
    const float safe = pv == 0.f ? 1.f : pv;
    for (int i = tid; i < nt; i += kThreads) {
      if (global_lane(i) == j0 + jj) {
        av[i] = 0.f;
        continue;
      }
      if (!(av[i] > 0.f)) continue;
      const float mu = __fdiv_rn(S[jj * ld + i], safe);
      S[jj * ld + i] = mu;
      // the pivot lane is retired, so its column stays as read; four
      // rows' loads are issued before their stores
      int r = jj + 1;
      for (; r + 3 < w; r += 4) {
        float x[4], pr[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          x[u] = S[(r + u) * ld + i];
          pr[u] = pc[(r + u) * ld];
        }
#pragma unroll
        for (int u = 0; u < 4; ++u)
          S[(r + u) * ld + i] = __fsub_rn(x[u], __fmul_rn(pr[u], mu));
      }
      for (; r < w; ++r)
        S[r * ld + i] = __fsub_rn(S[r * ld + i], __fmul_rn(pc[r * ld], mu));
    }
    __syncthreads();   // the next pivot lane is whole
  }

  if (blockIdx.x == 0)
    for (int jj = tid; jj < w; jj += kThreads) {
      a.piv[jj] = j0 + jj;
      a.ok[jj] = a.avail_in[j0 + jj] > 0.f ? 1 : 0;
    }
  for (int r = 0; r < w; ++r)
    for (int i = tid; i < nl; i += kThreads)
      a.mt_out[(size_t)r * m + lane0 + i] = S[r * ld + i];
  for (int i = tid; i < nl; i += kThreads) a.avail_out[lane0 + i] = av[i];
}

// --------------------------------------------------------------- grid route

struct GridArgs {
  const float* mt_in;
  const float* avail_in;
  float* mt_out;
  float* avail_out;
  int* piv;
  int* ok;
  float* head;   // [2][grid][kHead] candidate records, double-buffered
  float* cols;   // [2][grid][w] each candidate lane's column values
  // clustered exchange: the tag base, which the call advances by w, and
  // [2][kMaxLeaders][slot_words(w)] the leaders' tagged slots
  uint32_t* epoch;
  uint4* slots;
  int w;
  int m;
  int lanes;     // lanes per CTA
  int forced;
  int j0;
};

// dynamic shared memory of a grid CTA: the slab with an odd row stride
// (if it fits), avail, and the pivot column
size_t grid_smem_bytes(int w, int lanes, bool slab) {
  return ((slab ? (size_t)w * (lanes | 1) : 0) + lanes + w) * sizeof(float);
}

template <bool kSlab>
__global__ void __launch_bounds__(kThreads, 1) rank1_grid_kernel(GridArgs a) {
  extern __shared__ float smem[];
  __shared__ float red_s[kWarps];
  __shared__ int red_i[kWarps];
  __shared__ int win_cta;

  const int w = a.w, m = a.m, L = a.lanes;
  const int G = gridDim.x;
  const int tid = threadIdx.x;
  const int lane0 = blockIdx.x * L;
  const int nl = min(L, m - lane0);  // >= 1: the host sizes the grid so

  // the slab holds this CTA's [w, nl] lanes: shared memory with row stride
  // L, or the output block itself with row stride m
  float* slab;
  size_t ld;
  float* avail_s;
  if (kSlab) {
    slab = smem;
    ld = L | 1;   // odd: a column's rows fall in distinct banks
    avail_s = smem + (size_t)w * ld;
  } else {
    slab = a.mt_out + lane0;
    ld = m;
    avail_s = smem;
  }
  float* pcol = avail_s + L;  // [w] pivot lane's column values

  for (int r = 0; r < w; ++r)
    for (int i = tid; i < nl; i += kThreads)
      slab[r * ld + i] = a.mt_in[(size_t)r * m + lane0 + i];
  for (int i = tid; i < nl; i += kThreads) avail_s[i] = a.avail_in[lane0 + i];
  __syncthreads();

  cg::grid_group grid = cg::this_grid();

  for (int jj = 0; jj < w; ++jj) {
    float* row = slab + jj * ld;

    // 1. this CTA's candidate: masked |x| argmax over its lanes
    const int fp = a.j0 + jj;
    float best = -INFINITY;
    int bi = INT_MAX;
    for (int i = tid; i < nl; i += kThreads) {
      const int gi = lane0 + i;
      float s;
      if (a.forced)
        s = gi == fp ? INFINITY : -INFINITY;
      else
        s = avail_s[i] > 0.f ? fabsf(row[i]) : -INFINITY;
      if (better(s, gi, best, bi)) {
        best = s;
        bi = gi;
      }
    }
    int unused = 0;
    warp_best(best, bi, unused);
    if ((tid & 31) == 0) {
      red_s[tid >> 5] = best;
      red_i[tid >> 5] = bi;
    }
    __syncthreads();
    // every warp reduces the warps' candidates itself (a real lane of this
    // CTA: nl >= 1 and -inf ties go low)
    best = red_s[tid % kWarps];
    bi = red_i[tid % kWarps];
    warp_best(best, bi, unused);
    best = __shfl_sync(0xffffffffu, best, 0);
    bi = __shfl_sync(0xffffffffu, bi, 0);

    // 2. publish it with its column values (rows jj..w-1), L2 only: the
    // records are rewritten every other column, and L1 is not coherent
    const int buf = jj & 1;
    const int li = bi - lane0;
    float* head = a.head + ((size_t)buf * G + blockIdx.x) * kHead;
    float* cbuf = a.cols + ((size_t)buf * G + blockIdx.x) * w;
    for (int r = jj + tid; r < w; r += kThreads) __stcg(cbuf + r, slab[r * ld + li]);
    if (tid == 0) {
      __stcg(head + 0, best);
      __stcg(head + 1, __int_as_float(bi));
      __stcg(head + 2, avail_s[li]);
    }

    // 3. one barrier per column. Double-buffered records are safe: a CTA
    // rewrites buffer `buf` only after the next barrier, which every CTA
    // reaches only after it has read this column's records.
    if (G > 1)
      grid.sync();
    else
      __syncthreads();

    // 4. every CTA reduces the candidates in the same order
    if (tid < 32) {
      float s = -INFINITY;
      int i = INT_MAX, c = 0;
      for (int k = tid; k < G; k += 32) {
        const float* h = a.head + ((size_t)buf * G + k) * kHead;
        const float ks = __ldcg(h);
        const int ki = __float_as_int(__ldcg(h + 1));
        if (better(ks, ki, s, i)) {
          s = ks;
          i = ki;
          c = k;
        }
      }
      warp_best(s, i, c);
      if (tid == 0) win_cta = c;
    }
    __syncthreads();
    const float* wh = a.head + ((size_t)buf * G + win_cta) * kHead;
    const float* wcol = a.cols + ((size_t)buf * G + win_cta) * w;
    const int p = __float_as_int(__ldcg(wh + 1));
    const float pv = __ldcg(wcol + jj);
    for (int r = jj + 1 + tid; r < w; r += kThreads) pcol[r] = __ldcg(wcol + r);
    if (blockIdx.x == 0 && tid == 0) {
      a.piv[jj] = p;
      a.ok[jj] = __ldcg(wh + 2) > 0.f ? 1 : 0;
    }
    __syncthreads();

    // 5. rank-1 update of this CTA's available, non-pivot lanes
    const float safe = pv == 0.f ? 1.f : pv;
    for (int i = tid; i < nl; i += kThreads) {
      if (lane0 + i == p) {
        avail_s[i] = 0.f;
        continue;
      }
      if (!(avail_s[i] > 0.f)) continue;
      const float mu = __fdiv_rn(row[i], safe);
      row[i] = mu;
      // four rows' loads issued before their stores
      int r = jj + 1;
      for (; r + 3 < w; r += 4) {
        float x[4], pr[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          x[u] = slab[(r + u) * ld + i];
          pr[u] = pcol[r + u];
        }
#pragma unroll
        for (int u = 0; u < 4; ++u)
          slab[(r + u) * ld + i] = __fsub_rn(x[u], __fmul_rn(pr[u], mu));
      }
      for (; r < w; ++r) {
        float* x = slab + r * ld + i;
        *x = __fsub_rn(*x, __fmul_rn(pcol[r], mu));
      }
    }
    __syncthreads();
  }

  if (kSlab)
    for (int r = 0; r < w; ++r)
      for (int i = tid; i < nl; i += kThreads)
        a.mt_out[(size_t)r * m + lane0 + i] = slab[r * ld + i];
  for (int i = tid; i < nl; i += kThreads) a.avail_out[lane0 + i] = avail_s[i];
}

// ------------------------------------------------ grid route, two levels

constexpr int kGridCluster = 8;      // CTAs a cluster of the clustered grid
constexpr int kMaxLeaders = 16;      // its clusters, at most
constexpr int kChain = 128;          // chain threads (warps 0-3)
constexpr int kBulk = 128;           // update threads (the warps after them)
constexpr int kBulkLanes = 4;        // lanes an update thread takes, at most
constexpr int kChainLanes = 4;       // lanes a chain thread takes, at most
constexpr int kGridThreads = kChain + kBulk;
// named barriers of the two warp groups (0 is __syncthreads): the chain
// group's own, "the update of column c is done", "it may start"
constexpr int kBarChain = 1;
constexpr int kBarDone = 2;
constexpr int kBarStart = 3;

__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(count) : "memory");
}
// arrive without waiting; it synchronizes with the threads' bar.sync on
// the barrier, so what this thread wrote before is visible to them after
__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(count) : "memory");
}

// a leader's slot word, 16 bytes through the L2: three payload floats and
// the column's tag, stored and loaded whole
__device__ __forceinline__ void st_word(uint4* p, uint4 v) {
  asm volatile("st.relaxed.gpu.global.v4.b32 [%0], {%1, %2, %3, %4};\n"
               :: "l"(p), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w) : "memory");
}
__device__ __forceinline__ uint4 ld_word(const uint4* p) {
  uint4 v;
  asm volatile("ld.relaxed.gpu.global.v4.b32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p)
               : "memory");
  return v;
}
// the tag base, read by every CTA at the start and advanced at the end
__device__ __forceinline__ uint32_t ld_u32(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.relaxed.gpu.global.b32 %0, [%1];\n" : "=r"(v) : "l"(p)
               : "memory");
  return v;
}
__device__ __forceinline__ void st_u32(uint32_t* p, uint32_t v) {
  asm volatile("st.relaxed.gpu.global.b32 [%0], %1;\n" :: "l"(p), "r"(v)
               : "memory");
}

// `better`'s order as one unsigned 64-bit key, so candidates reduce by a
// maximum: the score above (-inf lowest, then +0 .. +inf by their bits, NaN
// highest; scores are |x| or +-inf), the lane's complement below (lower
// lanes win ties; the placeholder lane INT_MAX loses to every real lane)
__device__ __forceinline__ uint32_t score_key(float s) {
  if (isnan(s)) return 0xffffffffu;
  return s == -INFINITY ? 0u : __float_as_uint(s) + 1u;
}
__device__ __forceinline__ uint64_t make_key(uint32_t hi, int lane) {
  return (static_cast<uint64_t>(hi) << 32) | static_cast<uint32_t>(~lane);
}
__device__ __forceinline__ int key_lane(uint64_t k) {
  return static_cast<int>(~static_cast<uint32_t>(k));
}
__device__ __forceinline__ uint64_t key_max(uint64_t a, uint64_t b) {
  return a > b ? a : b;
}
__device__ __forceinline__ uint64_t warp_max_key(uint64_t k) {
  const uint32_t hi = static_cast<uint32_t>(k >> 32);
  const uint32_t mh = __reduce_max_sync(0xffffffffu, hi);
  const uint32_t ml =
      __reduce_max_sync(0xffffffffu, hi == mh ? static_cast<uint32_t>(k) : 0u);
  return (static_cast<uint64_t>(mh) << 32) | ml;
}

// a leader's slot through the L2, in 16-byte words of three floats and a
// tag: float f = 3j + e of word j holds the key's score part (f = 0), the
// lane and avail bit (f = 1) and row f - 2 of the column
__host__ __device__ __forceinline__ int slot_words(int w) {
  return (w + 4) / 3;
}

// dynamic shared memory of a clustered grid CTA: two mbarriers and the
// leader's receive area (a slot per CTA of its cluster), both per column
// parity, the copy of every leader's slot (per column parity), avail and
// the [w, lanes] slab with an odd row stride
size_t clustered_smem_bytes(int w, int lanes) {
  return 2 * sizeof(uint64_t) +
         ((size_t)2 * kGridCluster * slot_floats(w) +
          (size_t)2 * kMaxLeaders * 3 * slot_words(w) + lanes +
          (size_t)w * (lanes | 1)) * sizeof(float);
}

// The grid route in clusters of kGridCluster CTAs, launched co-resident.
// Each column's exchange takes two levels: every CTA pushes its candidate
// record and column into its cluster leader's shared memory (st.async on
// the leader's mbarrier); the leader reduces them and stores the
// cluster's winner in its slot in the L2 with the column's tag in every
// word; every CTA reads every leader's slot until the tags match and
// reduces the records in the same order, so all find the same pivot with
// its column. Warp-specialised as K1 in double's cluster route: the chain
// warps run the exchange, the multipliers, row c+1 and the candidate for
// c+1, while the update warps apply column c-1's update to rows
// c+2..w-1. Row r gets columns up to r-3 from the update warps and columns
// r-2 and r-1 from the chain warps, so the two never touch one row at
// once. The chain waits for column c-1's update only before it publishes
// the candidate for c+1 (whose column must hold it), and retires pivot c
// only then (that update still reaches its lane).
__global__ void __launch_bounds__(kGridThreads, 1)
    rank1_grid_kernel_clustered(GridArgs a) {
  extern __shared__ uint64_t smem_raw[];
  __shared__ uint64_t red_k[2 * (kChain / 32)];
  __shared__ int pcol_at[2];   // the pivot slot's float in stage, by parity

  const int w = a.w, m = a.m, L = a.lanes;
  const int ncl = gridDim.x / kGridCluster;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rank = static_cast<int>(cg::this_cluster().block_rank());
  const int cl = blockIdx.x / kGridCluster;
  const bool leader = rank == 0;
  const int lane0 = blockIdx.x * L;
  const int nl = min(L, m - lane0);  // >= 1: the host sizes the grid so

  const int slot = slot_floats(w);
  const int sw = slot_words(w);
  uint64_t* gbar = smem_raw;          // [2] the leader's: its CTAs' candidates
  float* gather = reinterpret_cast<float*>(smem_raw + 2);  // [2][8][slot]
  // [2][kMaxLeaders][3 sw]: every leader's slot of column c, read back from
  // the L2, in stage + (c & 1) kMaxLeaders 3 sw; the pivot's column is the
  // slot's float 2 + row, and is rewritten for column c + 2 only after
  // column c's update
  float* stage = gather + 2 * kGridCluster * slot;
  float* avail_s = stage + 2 * kMaxLeaders * 3 * sw;        // [L]
  float* slab = avail_s + L;                                // [w][L | 1]
  const size_t ld = L | 1;
  // 16-byte words a CTA pushes for column c: the record, then the column
  // from the word that holds row c on
  auto col_words = [&](int c) { return 1 + (w + 3) / 4 - c / 4; };

  if (tid == 0) {
    for (int b = 0; b < 2; ++b) mbar_init(&gbar[b], 1);
    for (int c = 0; c < 2 && c < w; ++c)
      if (leader) mbar_expect_tx(&gbar[c], kGridCluster * col_words(c) * 16);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int r = 0; r < w; ++r)
    for (int i = tid; i < nl; i += kGridThreads)
      slab[r * ld + i] = a.mt_in[(size_t)r * m + lane0 + i];
  for (int i = tid; i < nl; i += kGridThreads) avail_s[i] = a.avail_in[lane0 + i];
  // every mbarrier of the cluster is armed before anyone sends
  cluster_arrive();
  cluster_wait();

  if (tid >= kChain) {
    // the update warps: column c's update of rows c+3..w-1 (rows c+1 and
    // c+2 get it from the chain). Each thread takes up to kBulkLanes lanes,
    // kBulk apart, over every row, four rows at a time: a row's pivot value
    // is loaded once for all its lanes, and a batch's loads are all issued
    // before its stores.
    const int tb = tid - kChain;
    for (int c = 0; c < w; ++c) {
      bar_sync(kBarStart, kGridThreads);
      const float* pc = stage + pcol_at[c & 1];
      const float* row = slab + c * ld;
      float mu[kBulkLanes];
      bool act[kBulkLanes];
      bool any = false;
#pragma unroll
      for (int u = 0; u < kBulkLanes; ++u) {
        const int i = tb + u * kBulk;
        act[u] = i < nl && avail_s[i] > 0.f;
        mu[u] = act[u] ? row[i] : 0.f;
        any |= act[u];
      }
      if (any) {
        int r = c + 3;
        for (; r + 3 < w; r += 4) {
          float pr[4], x[4][kBulkLanes];
#pragma unroll
          for (int k = 0; k < 4; ++k) pr[k] = pc[r + k];
#pragma unroll
          for (int k = 0; k < 4; ++k)
#pragma unroll
            for (int u = 0; u < kBulkLanes; ++u)
              if (act[u]) x[k][u] = slab[(r + k) * ld + tb + u * kBulk];
#pragma unroll
          for (int k = 0; k < 4; ++k)
#pragma unroll
            for (int u = 0; u < kBulkLanes; ++u)
              if (act[u])
                slab[(r + k) * ld + tb + u * kBulk] =
                    __fsub_rn(x[k][u], __fmul_rn(pr[k], mu[u]));
        }
        for (; r < w; ++r) {
          const float pr = pc[r];
#pragma unroll
          for (int u = 0; u < kBulkLanes; ++u)
            if (act[u]) {
              float* e = slab + r * ld + tb + u * kBulk;
              *e = __fsub_rn(*e, __fmul_rn(pr, mu[u]));
            }
        }
      }
      bar_arrive(kBarDone, kGridThreads);
    }
  } else {
    // the chain warps
    const uint32_t epoch = ld_u32(a.epoch);

    // the CTA's candidate from each chain thread's key: every chain thread
    // gets the same (red_k per column parity: a warp writes column c + 2's
    // only after the chain's wait for column c + 1's update)
    auto cta_key = [&](uint64_t k, int c) {
      uint64_t* red = red_k + (c & 1) * (kChain / 32);
      k = warp_max_key(k);
      if (lane == 0) red[warp] = k;
      bar_sync(kBarChain, kChain);
      k = red[0];
#pragma unroll
      for (int q = 1; q < kChain / 32; ++q) k = key_max(k, red[q]);
      return k;
    };
    // this thread's 16-byte word of the candidate `key` for column c, as
    // the CTA pushes it into the leader's receive slot (the host keeps
    // col_words(c) <= kChain): word 0 is the record, word j > 0 rows
    // 4 (c / 4 + j - 1) on. Rows past c of the column still owe column
    // c-1's update (it has not started), applied here as the update warps
    // will apply it with `prev`, column c-1's pivot column. Lane `retired`
    // (column c-1's pivot) counts as unavailable. In two parts: `pre`
    // loads what column c-2's update does not touch (the lane's avail and
    // multiplier, the pivot column's rows), `word` the rest once that
    // update is done, and returns the word's first float in the slot, or
    // -1.
    struct Pre {
      float a, m, pr[4];
    };
    auto candidate_pre = [&](int c, uint64_t key, const float* prev) {
      Pre q{0.f, 0.f, {0.f, 0.f, 0.f, 0.f}};
      const int j = tid;
      if (j >= col_words(c)) return q;
      const int li = key_lane(key) - lane0;
      q.a = avail_s[li];
      if (c > 0) q.m = slab[(size_t)(c - 1) * ld + li];
      const int r0 = 4 * (c / 4 + j - 1);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (j > 0 && c > 0 && r0 + e < w) q.pr[e] = prev[r0 + e];
      return q;
    };
    auto candidate_word = [&](int c, uint64_t key, int retired, const Pre& q,
                              float4& v) {
      const int j = tid;
      if (j >= col_words(c)) return -1;
      const int bi = key_lane(key);
      const int li = bi - lane0;
      const bool av = bi != retired && q.a > 0.f;
      if (j == 0) {
        const uint32_t rec1 =
            (static_cast<uint32_t>(bi) << 1) | (av ? 1u : 0u);
        v = make_float4(__uint_as_float(static_cast<uint32_t>(key >> 32)),
                        __uint_as_float(rec1), 0.f, 0.f);
        return 0;
      }
      const bool upd = c > 0 && av;
      const float mu = upd ? q.m : 0.f;
      const int r0 = 4 * (c / 4 + j - 1);   // rows r0..r0+3
      float x[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = r0 + e;
        float y = 0.f;
        if (r >= c && r < w) {
          y = slab[r * ld + li];
          if (upd && r > c) y = __fsub_rn(y, __fmul_rn(q.pr[e], mu));
        }
        x[e] = y;
      }
      v = make_float4(x[0], x[1], x[2], x[3]);
      return 4 + r0;
    };
    // push it, completing its bytes on the leader's mbarrier
    auto push_word = [&](int c, int off, float4 v) {
      if (off < 0) return;
      const int buf = c & 1;
      float* mine = gather + (buf * kGridCluster + rank) * slot;
      st_async(map_rank(mine + off, 0), v, map_rank(&gbar[buf], 0));
    };
    // the record at float rec (key score part, lane and avail bit) as a key
    auto rec_key = [](const float* rec) {
      return make_key(__float_as_uint(rec[0]),
                      static_cast<int>(__float_as_uint(rec[1]) >> 1));
    };
    // the leader's part of column c's exchange: its cluster's winner into
    // its slot in the L2
    auto lead = [&](int c) {
      const int buf = c & 1;
      mbar_wait_cluster(&gbar[buf], (c >> 1) & 1);
      // every chain warp reduces the cluster's records alike
      const float* recs = gather + buf * kGridCluster * slot;
      const uint64_t k = lane < kGridCluster ? rec_key(recs + lane * slot) : 0;
      const uint64_t kw = warp_max_key(k);
      const float* src =
          recs + (__ffs(__ballot_sync(0xffffffffu, k == kw)) - 1) * slot;
      // the slot's words of column c: the record's, then those from the
      // one that holds row c on (words below hold only rows before c)
      const uint32_t tag = epoch + static_cast<uint32_t>(c) + 1u;
      const int j1 = max(1, (c + 2) / 3);
      const int n = 1 + sw - j1;
      uint4* gs = a.slots + (size_t)buf * kMaxLeaders * sw + cl * sw;
      for (int q = tid; q < n; q += kChain) {
        const int j = q == 0 ? 0 : j1 + q - 1;
        uint32_t x[3];
#pragma unroll
        for (int e = 0; e < 3; ++e) {
          const int f = 3 * j + e;
          x[e] = f < 2 ? __float_as_uint(src[f])
                       : f - 2 < w ? __float_as_uint(src[4 + f - 2]) : 0u;
        }
        st_word(gs + j, make_uint4(x[0], x[1], x[2], tag));
      }
      // this receive area has been read, before any CTA can send column
      // c + 2 into it (that takes the pivot of c + 1, which takes this
      // leader's slot of c + 1): arm it for that column
      if (tid == 0 && c + 2 < w)
        mbar_expect_tx(&gbar[buf], kGridCluster * col_words(c + 2) * 16);
    };
    // the pivot lane of column c: every CTA reads every leader's slot of
    // the column back from the L2 and reduces the records in the same
    // order; the pivot's column is then at stage + `at` (and, for the
    // update warps, stage + pcol_at[c & 1])
    auto exchange = [&](int c, int& at) {
      const int buf = c & 1;
      if (leader) lead(c);
      // every leader's words of column c, all loads in flight at once,
      // each loaded again until its tag is this column's; word q of the
      // ncl n is word q % n of slot q / n (the quotient from a reciprocal,
      // exact while ncl n is small). A slot is rewritten (column c + 2)
      // only after every CTA has read this column's: that needs every
      // CTA's candidate for c + 2, sent after its pivot of c + 1.
      const uint32_t tag = epoch + static_cast<uint32_t>(c) + 1u;
      const int j1 = max(1, (c + 2) / 3);
      const int n = 1 + sw - j1;
      const uint4* gs = a.slots + (size_t)buf * kMaxLeaders * sw;
      float* st = stage + buf * kMaxLeaders * 3 * sw;
      const int total = ncl * n;
      const float rn = 1.f / n;
      for (int q0 = tid; q0 < total; q0 += 8 * kChain) {
        const uint4* srcw[8];
        float* dst[8];
        uint32_t pending = 0;
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int q = q0 + u * kChain;
          const int kq = static_cast<int>((q + 0.5f) * rn);
          const int jq = q - kq * n;
          const int j = jq == 0 ? 0 : j1 + jq - 1;
          srcw[u] = gs + kq * sw + j;
          dst[u] = st + kq * 3 * sw + 3 * j;
          if (q < total) pending |= 1u << u;
        }
        uint4 v[8];
        while (pending) {
#pragma unroll
          for (int u = 0; u < 8; ++u)
            if (pending >> u & 1u) v[u] = ld_word(srcw[u]);
#pragma unroll
          for (int u = 0; u < 8; ++u)
            if ((pending >> u & 1u) && v[u].w == tag) {
              dst[u][0] = __uint_as_float(v[u].x);
              dst[u][1] = __uint_as_float(v[u].y);
              dst[u][2] = __uint_as_float(v[u].z);
              pending &= ~(1u << u);
            }
        }
      }
      bar_sync(kBarChain, kChain);
      const uint64_t k = lane < ncl ? rec_key(st + lane * 3 * sw) : 0;
      const uint64_t kp = warp_max_key(k);
      at = buf * kMaxLeaders * 3 * sw +
           (__ffs(__ballot_sync(0xffffffffu, k == kp)) - 1) * 3 * sw;
      const uint32_t r1 = __float_as_uint(stage[at + 1]);
      const int p = static_cast<int>(r1 >> 1);
      at += 2;
      if (tid == 0) {
        pcol_at[buf] = at;
        if (blockIdx.x == 0) {
          a.piv[c] = p;
          a.ok[c] = static_cast<int>(r1 & 1u);
        }
      }
      return p;
    };

    {
      uint64_t k = make_key(0u, INT_MAX);
      for (int i = tid; i < nl; i += kChain) {
        const int gi = lane0 + i;
        float s;
        if (a.forced)
          s = gi == a.j0 ? INFINITY : -INFINITY;
        else
          s = avail_s[i] > 0.f ? fabsf(slab[i]) : -INFINITY;
        k = key_max(k, make_key(score_key(s), gi));
      }
      float4 v;
      const uint64_t key = cta_key(k, 0);
      const int off =
          candidate_word(0, key, -1, candidate_pre(0, key, stage), v);
      push_word(0, off, v);
    }

    int at = 0, at_prev = 0;   // the pivot columns of c and c-1 in stage
    for (int c = 0; c < w; ++c) {
      at_prev = at;
      const int p = exchange(c, at);
      const float* pc = stage + at;
      const float* prev = stage + at_prev;
      const float pv = pc[c];
      const float safe = pv == 0.f ? 1.f : pv;
      float* row = slab + c * ld;
      float* next = row + ld;
      const bool more = c + 1 < w;
      const float pn = more ? pc[c + 1] : 0.f;
      const float pp = more && c > 0 ? prev[c + 1] : 0.f;
      const int fp = a.j0 + c + 1;

      // 1. row c+1's update by column c-1 (pivot c still counts as
      // available: its lane took that column), the multipliers of column
      // c, row c+1's update by column c, and this thread's candidate for
      // column c+1 with pivot c left out: each of this thread's lanes
      // loaded first, then computed, then stored
      float av[kChainLanes], ro[kChainLanes], nx[kChainLanes],
          rp[kChainLanes], mu[kChainLanes];
#pragma unroll
      for (int u = 0; u < kChainLanes; ++u) {
        const int i = tid + u * kChain;
        av[u] = ro[u] = nx[u] = rp[u] = 0.f;
        if (i < nl) {
          av[u] = avail_s[i];
          ro[u] = row[i];
          if (more) nx[u] = next[i];
          if (c > 0) rp[u] = row[i - ld];
        }
      }
#pragma unroll
      for (int u = 0; u < kChainLanes; ++u)
        mu[u] = tid + u * kChain < nl ? __fdiv_rn(ro[u], safe) : 0.f;
      uint64_t key = make_key(0u, INT_MAX);
#pragma unroll
      for (int u = 0; u < kChainLanes; ++u) {
        const int i = tid + u * kChain;
        const int gi = lane0 + i;
        if (av[u] > 0.f) {
          if (more && c > 0) nx[u] = __fsub_rn(nx[u], __fmul_rn(pp, rp[u]));
          if (gi != p) {
            row[i] = mu[u];
            if (more) nx[u] = __fsub_rn(nx[u], __fmul_rn(pn, mu[u]));
          }
          if (more) next[i] = nx[u];
        }
        if (more && i < nl) {
          float s;
          if (a.forced)
            s = gi == fp ? INFINITY : -INFINITY;
          else
            s = av[u] > 0.f && gi != p ? fabsf(nx[u]) : -INFINITY;
          key = key_max(key, make_key(score_key(s), gi));
        }
      }
      if (more) key = cta_key(key, c + 1);
      // 2. column c-1's update is done: retire pivot c (its lane's own
      // thread, which reads it next), read the candidate for c+1, let
      // column c's update start, then push the candidate
      Pre q{};
      if (more) q = candidate_pre(c + 1, key, pc);
      if (c > 0) bar_sync(kBarDone, kGridThreads);
      if (p - lane0 >= 0 && p - lane0 < nl && (p - lane0) % kChain == tid)
        avail_s[p - lane0] = 0.f;
      float4 v;
      const int off = more ? candidate_word(c + 1, key, p, q, v) : -1;
      bar_arrive(kBarStart, kGridThreads);
      push_word(c + 1, off, v);
    }
    bar_sync(kBarDone, kGridThreads);    // the last column's update
    // every leader has read the tag base, since every leader's slot of the
    // last column is in: the next call on this scratch takes the next tags
    if (blockIdx.x == 0 && tid == 0) st_u32(a.epoch, epoch + w);
  }
  __syncthreads();
  // no CTA leaves while a peer's stores into it may be in flight
  cluster_arrive();
  cluster_wait();

  for (int r = 0; r < w; ++r)
    for (int i = tid; i < nl; i += kGridThreads)
      a.mt_out[(size_t)r * m + lane0 + i] = slab[r * ld + i];
  for (int i = tid; i < nl; i += kGridThreads) a.avail_out[lane0 + i] = avail_s[i];
}

int ceil_div(int a, int b) { return (a + b - 1) / b; }

// what a device offers K1, found once per process and device
struct DeviceInfo {
  cudaError_t err;
  int sms;
  size_t smem;       // dynamic shared memory a CTA may take
  int cluster;       // largest cluster the cluster kernel is granted (<= 16)
  int grid_clusters; // clusters of kGridCluster co-resident (0: flat grid route)
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
      reinterpret_cast<const void*>(&rank1_cluster_kernel),
      reinterpret_cast<const void*>(&rank1_grid_kernel<true>),
      reinterpret_cast<const void*>(&rank1_grid_kernel<false>),
      reinterpret_cast<const void*>(&rank1_tile_kernel),
      reinterpret_cast<const void*>(&rank1_grid_kernel_clustered)};
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
    e = cudaOccupancyMaxActiveClusters(&n, rank1_cluster_kernel, &cfg);
    if (e != cudaSuccess) {
      cudaGetLastError();   // a refused size is an answer, not a fault
      continue;
    }
    if (n >= 1) d.cluster = c;
  }
  if (d.cluster == 0) return cudaErrorNotSupported;
  // clusters of the clustered grid route the card holds at once, one CTA
  // an SM; none leaves the grid route its flat exchange
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kGridCluster * kMaxLeaders);
  cfg.blockDim = dim3(kGridThreads);
  cfg.dynamicSmemBytes = d.smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kGridCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  d.grid_clusters = 0;
  if (cudaOccupancyMaxActiveClusters(&d.grid_clusters,
                                     rank1_grid_kernel_clustered, &cfg) !=
      cudaSuccess) {
    cudaGetLastError();
    d.grid_clusters = 0;
  }
  return cudaSuccess;
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

// a grid-route launch: G CTAs of `lanes` lanes, in clusters of `cluster`
// CTAs with the two-level exchange (0: the flat exchange, whose slab is in
// shared memory if `slab`), and its dynamic shared memory
struct GridPlan {
  int G, lanes, cluster;
  bool slab;
  size_t smem;
};

// The grid route's launch of a [w, m] block, from (w, m) and the card
// alone: clusters of kGridCluster CTAs, as many as the card holds at once
// (at most kMaxLeaders), with about kLanesPerCta lanes a CTA, fewer where
// the slab would not fit and more where the CTAs are all taken. Blocks that
// the clustered slab cannot hold, and cards that hold no such cluster, take
// the flat exchange: one CTA an SM with its slab in shared memory where it
// fits, else in the output through the L2.
GridPlan grid_plan(const DeviceInfo& d, int w, int m) {
  const int maxg = std::min(d.grid_clusters, kMaxLeaders) * kGridCluster;
  if (maxg > 0) {
    // the most lanes a CTA holds at width w
    const size_t fixed = clustered_smem_bytes(w, 0);
    int fit = fixed + sizeof(float) * (w + 1) > d.smem ? 0 :
        static_cast<int>((d.smem - fixed) / sizeof(float) - w) / (w + 1);
    while (fit > 0 && clustered_smem_bytes(w, fit) > d.smem) --fit;
    fit = std::min({fit, kBulk * kBulkLanes, kChain * kChainLanes});
    // a candidate's words, one a chain thread
    if (fit > 0 && 1 + (w + 3) / 4 <= kChain) {
      const int aim = std::min(kLanesPerCta, fit);
      int G = std::min(maxg, ceil_div(ceil_div(m, aim), kGridCluster) *
                                 kGridCluster);
      // no CTA without a lane
      while (G > kGridCluster && (G - 1) * ceil_div(m, G) >= m)
        G -= kGridCluster;
      const int L = ceil_div(m, G);
      if (L <= fit && (G - 1) * L < m)
        return {G, L, kGridCluster, true, clustered_smem_bytes(w, L)};
    }
  }
  // at most one CTA per SM, so the grid is always co-resident
  const int g0 = std::min(std::min(d.sms, kMaxGrid), ceil_div(m, kLanesPerCta));
  const int L = ceil_div(m, g0);
  const int G = ceil_div(m, L);
  const size_t smem = grid_smem_bytes(w, L, true);
  if (smem <= d.smem) return {G, L, 0, true, smem};
  return {G, L, 0, false, grid_smem_bytes(w, L, false)};
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

// floats of scratch for blocks of width w: the flat grid route's candidate
// records and columns, then the clustered one's tag base and the leaders'
// slots. The clustered route needs it zeroed once and then kept for the
// calls of one stream: each call takes the tags after the last call's.
int conflux_rank1_panel_scratch_floats(int w) {
  return 2 * kMaxGrid * (kHead + w) + 4 + 2 * kMaxLeaders * slot_words(w) * 4;
}

// the cluster size of the grid route's launch for a [w, m] block on the
// current device (0: the flat exchange, or the device cannot be queried)
int conflux_rank1_panel_grid_cluster(int w, int m) {
  cudaError_t e;
  const DeviceInfo* d = device_info(e);
  return d ? grid_plan(*d, w, m).cluster : 0;
}

// the largest m the cluster route takes at width w on the current device
// (0 if the device cannot be queried)
int conflux_rank1_panel_cluster_max_m(int w) {
  cudaError_t e;
  const DeviceInfo* d = device_info(e);
  return d ? cluster_max_m(*d, w) : 0;
}

// the route conflux_rank1_panel takes for a [w, m] block (1 cluster, 2
// grid, 3 tile; 0 if the device cannot be queried)
int conflux_rank1_panel_route(int w, int m, int forced) {
  cudaError_t e;
  const DeviceInfo* d = device_info(e);
  return d ? route_for(*d, w, m, forced != 0) : 0;
}

const char* conflux_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Launch K1 on `stream`. *route receives the route taken (1 cluster, 2
// grid, 3 tile), chosen from (w, m) and the mode alone, and *cluster the
// cluster size of a grid-route launch with the two-level exchange (0
// otherwise). `scratch` holds conflux_rank1_panel_scratch_floats(w) floats,
// zeroed before the first call and kept for the calls of one stream.
// Returns 0 or a cudaError_t code (a refused launch included); never
// synchronises.
int conflux_rank1_panel(const float* mt_in, const float* avail_in,
                        float* mt_out, float* avail_out, int* piv, int* ok,
                        float* scratch, int w, int m, int forced, int j0,
                        void* stream, int* route, int* cluster) {
  if (w < 1 || m < 1 || m > 65536) return cudaErrorInvalidValue;
  cudaError_t e;
  const DeviceInfo* d = device_info(e);
  if (d == nullptr) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Route r = route_for(*d, w, m, forced != 0);

  *cluster = 0;
  if (r == kRouteTile) {
    *route = kRouteTile;
    ClusterArgs args{mt_in, avail_in, mt_out, avail_out, piv, ok,
                     w, m, kTileLanes, forced, j0};
    rank1_tile_kernel<<<ceil_div(m, kTileLanes), kThreads,
                        tile_smem_bytes(w, kTileLanes + w), s>>>(args);
    return cudaGetLastError();
  }
  if (r == kRouteCluster) {
    *route = kRouteCluster;
    int c = d->cluster;
    while (c > 1 && (c / 2) * kMinClusterLanes >= m) c /= 2;
    const int L = ceil_div(m, c);
    const int G = ceil_div(m, L);   // <= c
    ClusterArgs args{mt_in, avail_in, mt_out, avail_out, piv, ok,
                     w, m, L, forced, j0};
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(G);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = cluster_smem_bytes(w, L);
    cfg.stream = s;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = G;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    e = cudaLaunchKernelEx(&cfg, rank1_cluster_kernel, args);
    if (e != cudaSuccess) return e;
    return cudaGetLastError();
  }

  *route = kRouteGrid;
  const GridPlan g = grid_plan(*d, w, m);
  float* tail = scratch + 2 * kMaxGrid * (kHead + w);
  GridArgs args{mt_in, avail_in, mt_out, avail_out, piv, ok,
                scratch, scratch + 2 * kMaxGrid * kHead,
                reinterpret_cast<uint32_t*>(tail),
                reinterpret_cast<uint4*>(tail + 4), w, m, g.lanes, forced, j0};
  if (g.cluster) {
    // co-resident: every cluster of the grid is held at once
    *cluster = g.cluster;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(g.G);
    cfg.blockDim = dim3(kGridThreads);
    cfg.dynamicSmemBytes = g.smem;
    cfg.stream = s;
    cudaLaunchAttribute attr[2];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = g.cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    attr[1].id = cudaLaunchAttributeCooperative;
    attr[1].val.cooperative = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 2;
    e = cudaLaunchKernelEx(&cfg, rank1_grid_kernel_clustered, args);
    if (e != cudaSuccess) return e;
    return cudaGetLastError();
  }
  void* fn = g.slab ? reinterpret_cast<void*>(&rank1_grid_kernel<true>)
                    : reinterpret_cast<void*>(&rank1_grid_kernel<false>);
  void* params[] = {&args};
  e = cudaLaunchCooperativeKernel(fn, dim3(g.G), dim3(kThreads), params, g.smem,
                                  s);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // extern "C"
