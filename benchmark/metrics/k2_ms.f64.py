"""The f64 products' device time per factorization: every library matrix
product of the float64 path (cuBLAS and cutlass kernels, by kernel
name), which holds the step loop's big-K products (ops.gemm.sub_dot) and
also the panel's and the TRSMs' f64 products (ops.tri.schur_dot)."""

from benchmark.trace import per_factor_ms

LAYER = "f64 products (ops.gemm.sub_dot, ops.tri.schur_dot -> cuBLAS)"
UNIT = "ms"
SOURCE = "device_trace"
MOVES = "factor_ms"
GROUPS = ("GEMMs (cuBLAS, cutlass)", "bf16 GEMMs (cuBLAS nvjet)")


def compute(s: dict):
    return per_factor_ms(s["trace"], GROUPS)
