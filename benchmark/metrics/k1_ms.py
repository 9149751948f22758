"""K1's device time per factorization: its grid, cluster and tile
routes (csrc/rank1_panel.cu, by kernel name)."""

from benchmark.trace import per_factor_ms

LAYER = "K1 rank1_panel (ops.cuda_panel)"
UNIT = "ms"
SOURCE = "device_trace"
MOVES = "factor_ms"
GROUPS = ("K1 rank1 grid route", "K1 rank1 cluster route",
          "K1 rank1 tile route")


def compute(s: dict):
    return per_factor_ms(s["trace"], GROUPS)
