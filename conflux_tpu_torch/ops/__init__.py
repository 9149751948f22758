from conflux_tpu_torch.ops.cplx import cabs1, cschur_dot
from conflux_tpu_torch.ops.panel import lu_nopivot, select_pivots
from conflux_tpu_torch.ops.tri import (
    inv_lower,
    inv_unit_lower,
    inv_upper,
    potrf_tile,
    trsm_left_lower_unit,
    trsm_right_lower_t,
    trsm_right_upper,
    unit_lower,
    upper,
)

__all__ = [
    "select_pivots",
    "cschur_dot",
    "cabs1",
    "lu_nopivot",
    "unit_lower",
    "upper",
    "inv_lower",
    "inv_unit_lower",
    "inv_upper",
    "potrf_tile",
    "trsm_left_lower_unit",
    "trsm_right_lower_t",
    "trsm_right_upper",
]
