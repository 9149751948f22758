// Native host runtime for conflux-tpu's PyTorch port (a copy of the JAX
// package's conflux_tpu/native/src/conflux_host.cc: the same seeded fill,
// so both packages generate the same benchmark matrices).
//
// Equivalents of the reference's C++/OpenMP host utilities:
//   * row permutation kernels    (src/conflux/lu/utils.hpp:13-160)
//   * strided parallel copies    (src/conflux/lu/memory_utils.hpp:8-49)
//   * seeded benchmark fill      (src/conflux/lu/lu_params.hpp:364-375)
//   * region profiler            (libs/semiprof, PE/PL/PP/PC macros)
//
// The device compute path is PyTorch and CUDA; this library serves the
// host side: data generation and staging ahead of the upload, result
// reassembly, and low-overhead host-region timing. Exposed as a plain C ABI
// for ctypes.

#include <algorithm>
#include <chrono>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <map>
#include <random>
#include <string>
#include <vector>

#if defined(_OPENMP)
#include <omp.h>
#endif

extern "C" {

// ---------------------------------------------------------------------------
// Seeded benchmark fill: 5 + U[0,1), deterministic per (seed, row) so
// generation parallelizes over rows (the reference seeds per MPI rank).
// The per-row seed runs through a splitmix64 finalizer so adjacent seeds do
// NOT share row streams (seed+1 would otherwise reproduce seed's rows
// shifted by one).
// ---------------------------------------------------------------------------
static inline uint64_t ct_mix(uint64_t seed, uint64_t i) {
  uint64_t z = seed + 0x9E3779B97F4A7C15ULL * (i + 1);
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ULL;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBULL;
  return z ^ (z >> 31);
}

void ct_fill_random_f32(float* out, int64_t m, int64_t n, uint64_t seed) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < m; ++i) {
    std::mt19937_64 eng(ct_mix(seed, static_cast<uint64_t>(i)));
    std::uniform_real_distribution<float> dist;
    float* row = out + i * n;
    for (int64_t j = 0; j < n; ++j) row[j] = 5.0f + dist(eng);
  }
}

void ct_fill_random_f64(double* out, int64_t m, int64_t n, uint64_t seed) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < m; ++i) {
    std::mt19937_64 eng(ct_mix(seed, static_cast<uint64_t>(i)));
    std::uniform_real_distribution<double> dist;
    double* row = out + i * n;
    for (int64_t j = 0; j < n; ++j) row[j] = 5.0 + dist(eng);
  }
}

// ---------------------------------------------------------------------------
// Row permutation: out[i, :] = in[perm[i], :]  (utils.hpp permute_rows)
// and the inverse out[perm[i], :] = in[i, :]   (inverse_permute_rows).
// ---------------------------------------------------------------------------
void ct_permute_rows_f32(const float* in, float* out, const int64_t* perm,
                         int64_t m, int64_t n) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < m; ++i)
    std::memcpy(out + i * n, in + perm[i] * n, sizeof(float) * n);
}

void ct_inverse_permute_rows_f32(const float* in, float* out,
                                 const int64_t* perm, int64_t m, int64_t n) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < m; ++i)
    std::memcpy(out + perm[i] * n, in + i * n, sizeof(float) * n);
}

// ---------------------------------------------------------------------------
// Strided submatrix copy (memory_utils.hpp mcopy / parallel_mcopy).
// ---------------------------------------------------------------------------
void ct_mcopy_f32(const float* src, float* dst, int64_t rows, int64_t cols,
                  int64_t src_stride, int64_t dst_stride) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < rows; ++i)
    std::memcpy(dst + i * dst_stride, src + i * src_stride,
                sizeof(float) * cols);
}

// Block-cyclic permutation: dense [M, N] -> cyclic-permuted device layout
// (the host half of layout.distribute; tile (i, j) of size v lands in the
// contiguous block of device (i % Px, j % Py)).
void ct_cyclic_permute_f32(const float* in, float* out, int64_t M, int64_t N,
                           int64_t v, int64_t Px, int64_t Py) {
  const int64_t mt = M / v, nt = N / v;
  const int64_t mtl = mt / Px, ntl = nt / Py;
  const int64_t Ml = mtl * v, Nl = ntl * v;
#pragma omp parallel for collapse(2) schedule(static)
  for (int64_t ti = 0; ti < mt; ++ti) {
    for (int64_t tj = 0; tj < nt; ++tj) {
      const int64_t pi = ti % Px, li = ti / Px;
      const int64_t pj = tj % Py, lj = tj / Py;
      const float* s = in + (ti * v) * N + tj * v;
      float* d = out + (pi * Ml + li * v) * (Py * Nl) + pj * Nl + lj * v;
      for (int64_t r = 0; r < v; ++r)
        std::memcpy(d + r * (Py * Nl), s + r * N, sizeof(float) * v);
    }
  }
}

// ---------------------------------------------------------------------------
// Region profiler (semiprof parity): nested region tree keyed by path.
// ---------------------------------------------------------------------------
namespace {
struct ProfNode {
  int64_t calls = 0;
  double wall = 0.0;
};
std::map<std::string, ProfNode> g_prof;
std::vector<std::pair<std::string, std::chrono::steady_clock::time_point>>
    g_stack;
std::string g_path;

void rebuild_path() {
  g_path.clear();
  for (auto& f : g_stack) {
    g_path += '/';
    g_path += f.first;
  }
}
}  // namespace

void ct_prof_enter(const char* name) {
  g_stack.emplace_back(name, std::chrono::steady_clock::now());
  rebuild_path();
  g_prof[g_path];  // create
}

void ct_prof_leave() {
  if (g_stack.empty()) return;
  auto& frame = g_stack.back();
  double dt = std::chrono::duration<double>(std::chrono::steady_clock::now() -
                                            frame.second)
                  .count();
  auto& node = g_prof[g_path];
  node.calls += 1;
  node.wall += dt;
  g_stack.pop_back();
  rebuild_path();
}

void ct_prof_clear() {
  g_prof.clear();
  g_stack.clear();
  g_path.clear();
}

// Render the sorted region table into buf (returns bytes written).
int64_t ct_prof_report(char* buf, int64_t cap) {
  double total = 0.0;
  for (auto& kv : g_prof)
    if (kv.first.find('/', 1) == std::string::npos) total += kv.second.wall;
  if (total <= 0) total = 1e-30;
  std::vector<std::pair<std::string, ProfNode>> items(g_prof.begin(),
                                                      g_prof.end());
  std::sort(items.begin(), items.end(), [](auto& a, auto& b) {
    return a.second.wall > b.second.wall;
  });
  int64_t off = 0;
  int w = std::snprintf(buf + off, cap - off, "%-48s%10s%14s%8s\n", "REGION",
                        "CALLS", "WALL(s)", "%");
  if (w > 0) off += w;
  for (auto& kv : items) {
    if (off >= cap - 128) break;
    w = std::snprintf(buf + off, cap - off, "%-48s%10lld%14.6f%8.1f\n",
                      kv.first.c_str(),
                      static_cast<long long>(kv.second.calls), kv.second.wall,
                      100.0 * kv.second.wall / total);
    if (w > 0) off += w;
  }
  return off;
}

int ct_num_threads() {
#if defined(_OPENMP)
  return omp_get_max_threads();
#else
  return 1;
#endif
}

// Convert a permutation vector (slot -> original row, the framework's
// `pivotIndsBuff` layout) into LAPACK getrf-style sequential-swap IPIV
// (1-based). Inherently a sequential state walk, so it lives here instead
// of an O(n) interpreted Python loop (seconds of host time at n=131072).
void ct_perm_to_ipiv(const int64_t* perm, int64_t* ipiv, int64_t n) {
  std::vector<int64_t> work(n), pos(n);
  for (int64_t i = 0; i < n; ++i) {
    work[i] = i;
    pos[i] = i;
  }
  for (int64_t i = 0; i < n; ++i) {
    int64_t j = pos[perm[i]];
    ipiv[i] = j + 1;
    int64_t wi = work[i], wj = work[j];
    work[i] = wj;
    work[j] = wi;
    pos[wi] = j;
    pos[wj] = i;
  }
}

}  // extern "C"
