"""K1's share of its roofline: the least time of the factorization's K1
work (benchmark.work.k1_least_ms: each block of the step loop read once
and written once, or its fp32 operations at the peak, the larger) over
K1's device time. None where the work has no step loop for the
configuration's path."""

from benchmark.trace import per_factor_ms

LAYER = "K1 rank1_panel (ops.cuda_panel)"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "factor_ms"
GROUPS = ("K1 rank1 grid route", "K1 rank1 cluster route",
          "K1 rank1 tile route")


def compute(s: dict):
    ms = per_factor_ms(s["trace"], GROUPS)
    least = s["work"]["k1_least_ms"]
    return None if ms is None or least is None else 100.0 * least / ms
