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
//   * grid route, for wider blocks: one persistent cooperative launch, one
//     CTA per SM with ~256 lanes. Per column each CTA publishes its
//     candidate with that lane's column values, one grid barrier makes
//     them visible, and every CTA reduces the candidates in the same
//     order. Blocks too wide for shared memory (m > ~59k at w = 128) work
//     on the output in global memory, which the 50 MB L2 holds. The
//     update's row loads are batched, the CTA's reduction is by shuffles
//     and the slab's row stride is odd (conflict-free column reads).
//     Tried and slower at [128, 32768] on the H100
//     (experiments/torch_kernel_ab.py, PERF.md): a tagged exchange (every
//     CTA polling every CTA's record), a split arrival count with the
//     lookahead in place of the grid barrier, and 512 threads per CTA with
//     two threads per lane in the update.
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

int ceil_div(int a, int b) { return (a + b - 1) / b; }

// what a device offers K1, found once per process and device
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
      reinterpret_cast<const void*>(&rank1_cluster_kernel),
      reinterpret_cast<const void*>(&rank1_grid_kernel<true>),
      reinterpret_cast<const void*>(&rank1_grid_kernel<false>),
      reinterpret_cast<const void*>(&rank1_tile_kernel)};
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

// floats of scratch the wrapper allocates for a block of width w (the
// grid route's candidate records and columns)
int conflux_rank1_panel_scratch_floats(int w) { return 2 * kMaxGrid * (kHead + w); }

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
// grid, 3 tile), chosen from (w, m) and the mode alone. Returns 0 or a cudaError_t code (a
// refused launch included); never synchronises.
int conflux_rank1_panel(const float* mt_in, const float* avail_in,
                        float* mt_out, float* avail_out, int* piv, int* ok,
                        float* scratch, int w, int m, int forced, int j0,
                        void* stream, int* route) {
  if (w < 1 || m < 1 || m > 65536) return cudaErrorInvalidValue;
  cudaError_t e;
  const DeviceInfo* d = device_info(e);
  if (d == nullptr) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Route r = route_for(*d, w, m, forced != 0);

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
  // at most one CTA per SM, so the grid is always co-resident
  const int g0 = std::min(std::min(d->sms, kMaxGrid), ceil_div(m, kLanesPerCta));
  const int L = ceil_div(m, g0);
  const int G = ceil_div(m, L);
  size_t smem = grid_smem_bytes(w, L, true);
  const bool slab = smem <= d->smem;
  void* fn;
  if (slab) {
    fn = reinterpret_cast<void*>(&rank1_grid_kernel<true>);
  } else {
    fn = reinterpret_cast<void*>(&rank1_grid_kernel<false>);
    smem = grid_smem_bytes(w, L, false);
  }
  GridArgs args{mt_in, avail_in, mt_out, avail_out, piv, ok,
                scratch, scratch + 2 * kMaxGrid * kHead, w, m, L, forced, j0};
  void* params[] = {&args};
  e = cudaLaunchCooperativeKernel(fn, dim3(G), dim3(kThreads), params, smem, s);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // extern "C"
