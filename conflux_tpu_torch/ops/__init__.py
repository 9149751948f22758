from conflux_tpu_torch.ops.panel import lu_nopivot, select_pivots
from conflux_tpu_torch.ops.tri import (
    potrf_tile,
    trsm_left_lower_unit,
    trsm_right_lower_t,
    trsm_right_upper,
    unit_lower,
    upper,
)

__all__ = [
    "select_pivots",
    "lu_nopivot",
    "unit_lower",
    "upper",
    "potrf_tile",
    "trsm_left_lower_unit",
    "trsm_right_lower_t",
    "trsm_right_upper",
]
