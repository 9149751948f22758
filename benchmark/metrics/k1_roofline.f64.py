"""K1 in double's share of its roofline: the least time of the
factorization's K1 work in double (the driver's `k1_least_ms`: each block
of the step loop read once and written once at 8 bytes, or its operations
at the FP64 peak of the CUDA cores, 34 TFLOP/s, the larger) over K1 in
double's device time. None where the work has no step loop for the
configuration's path."""

from benchmark.trace import per_factor_ms

LAYER = "K1 in double rank1_panel_f64 (ops.cuda_panel)"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "factor_ms"
GROUPS = ("K1 f64 grid route", "K1 f64 cluster route", "K1 f64 tile route")


def compute(s: dict):
    ms = per_factor_ms(s["trace"], GROUPS)
    least = s["work"]["k1_least_ms"]
    return None if ms is None or least is None else 100.0 * least / ms
