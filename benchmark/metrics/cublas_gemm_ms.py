"""The library's matrix products per factorization, device time: the
panel's fp32 products and one-hots and the TRSMs' products (cuBLAS and
cutlass kernels, by kernel name)."""

from benchmark.trace import per_factor_ms

LAYER = "library GEMMs (ops.panel, ops.tri)"
UNIT = "ms"
SOURCE = "device_trace"
MOVES = "factor_ms"
GROUPS = ("GEMMs (cuBLAS, cutlass)", "bf16 GEMMs (cuBLAS nvjet)")


def compute(s: dict):
    return per_factor_ms(s["trace"], GROUPS)
