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
// is updated where it lies. The mainloop (ring, split, MMAs) lives in
// mma_tile.cuh, shared with K2 (bigk_gemm.cu). wgmma and TMA are later
// work.

#include "mma_tile.cuh"

namespace {

using namespace conflux_mma;

struct Args {
  void* r;          // &R[0, c0]
  int ldr;
  Operands op;      // A [m, k], B [k, nt]; the R span is [m, nt]
  int tiles_m, tiles_n;
};

template <bool kX3, bool kVec, typename T>
__global__ void __launch_bounds__(kThreads) schur_update_kernel(Args a) {
  extern __shared__ __align__(128) float smem[];
  int row0, col0;
  tile_origin(blockIdx.x, a.tiles_m, a.tiles_n, row0, col0);
  Acc acc;
  mainloop<kX3, kVec>(a.op, smem, row0, col0, 0, acc);

  // epilogue: accumulator tile through shared memory, then one
  // read-subtract-round-write of each R element
  float* cs = smem;
  stage_acc(acc, cs);
  T* r = static_cast<T*>(a.r);
  for (int idx = threadIdx.x; idx < kBM * kBN; idx += kThreads) {
    const int i = idx / kBN, j = idx % kBN;
    const int gr = row0 + i, gc = col0 + j;
    if (gr < a.op.m && gc < a.op.nt) {
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
  return operands_16b_aligned(args.op) ? launch<kX3, true, T>(args, stream)
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
  Args args{r, ldr, Operands{a, b, lda, ldb, m, nt, k},
            (m + kBM - 1) / kBM, (nt + kBN - 1) / kBN};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (passes == 3)
    return r_bf16 ? launch_aligned<true, __nv_bfloat16>(args, s)
                  : launch_aligned<true, float>(args, s);
  return r_bf16 ? launch_aligned<false, __nv_bfloat16>(args, s)
                : launch_aligned<false, float>(args, s);
}

}  // extern "C"
