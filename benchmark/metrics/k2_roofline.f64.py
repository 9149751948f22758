"""The big-K products' share of their roofline in double: the least time
of the step loop's big-K products R - A @ B (the driver's `k2_least_ms`:
one product per call at the peak of the precision's type, 67 TFLOP/s on
the FP64 tensor cores, or R, A and B read once and the result written
once at 8 bytes, the larger, summed over the calls) over the f64
products' device time. That denominator also holds the panel's and the
TRSMs' f64 products, so the share is a lower bound on the big-K
products' own. None where the work has no peak for the configuration's
precision or path."""

from benchmark.trace import per_factor_ms

LAYER = "f64 products (ops.gemm.sub_dot, ops.tri.schur_dot -> cuBLAS)"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "factor_ms"
GROUPS = ("GEMMs (cuBLAS, cutlass)", "bf16 GEMMs (cuBLAS nvjet)")


def compute(s: dict):
    ms = per_factor_ms(s["trace"], GROUPS)
    least = s["work"]["k2_least_ms"]
    return None if ms is None or least is None else 100.0 * least / ms
