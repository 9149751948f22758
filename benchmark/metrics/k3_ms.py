"""K3's device time per factorization on rank 0: the trailing updates'
wgmma kernel and its split pass into bf16 hi/lo copies
(csrc/schur_update.cu, by kernel name). The split pass's group is shared
with K2, which the right-looking 2.5D program does not run."""

from benchmark.trace import per_factor_ms

LAYER = "K3 schur_update (ops.cuda_gemm)"
UNIT = "ms"
SOURCE = "device_trace"
MOVES = "peak_gib"  # the cell holds the time per layer: factor_ms.p25d
GROUPS = ("K3 schur_update_wgmma_kernel", "split pass of K3 and K2")


def compute(s: dict):
    return per_factor_ms(s["trace"], GROUPS)
