"""K2's device time per factorization: its products and split-K sums and
its split pass into bf16 hi/lo copies (csrc/bigk_gemm.cu, by kernel
name)."""

from benchmark.trace import per_factor_ms

LAYER = "K2 bigk_gemm (ops.cuda_gemm)"
UNIT = "ms"
SOURCE = "device_trace"
MOVES = "factor_ms"
GROUPS = ("K2 sub_matmul_bigk (+ split-K sum)", "split pass of K3 and K2")


def compute(s: dict):
    return per_factor_ms(s["trace"], GROUPS)
