"""K2's share of its roofline: the least time of the step loop's big-K
products R - A @ B (benchmark.work.k2_least_ms: the passes the
precision asks for at the peak of their type, or R, A and B read once
and the result written once, the larger, summed over the calls) over
K2's device time, split pass included. None where the work has no
peak for the configuration's precision or path."""

from benchmark.trace import per_factor_ms

LAYER = "K2 bigk_gemm (ops.cuda_gemm)"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "factor_ms"
GROUPS = ("K2 sub_matmul_bigk (+ split-K sum)", "split pass of K3 and K2")


def compute(s: dict):
    ms = per_factor_ms(s["trace"], GROUPS)
    least = s["work"]["k2_least_ms"]
    return None if ms is None or least is None else 100.0 * least / ms
