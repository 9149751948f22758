"""K1 in double's device time per factorization: its grid, cluster and
tile routes (csrc/rank1_panel_f64.cu, by kernel name)."""

from benchmark.trace import per_factor_ms

LAYER = "K1 in double rank1_panel_f64 (ops.cuda_panel)"
UNIT = "ms"
SOURCE = "device_trace"
MOVES = "factor_ms"
GROUPS = ("K1 f64 grid route", "K1 f64 cluster route", "K1 f64 tile route")


def compute(s: dict):
    return per_factor_ms(s["trace"], GROUPS)
