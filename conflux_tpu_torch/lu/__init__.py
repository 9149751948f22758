from conflux_tpu_torch.lu.cp25d import clu_25d
from conflux_tpu_torch.lu.csingle import clu_factor, clu_residual
from conflux_tpu_torch.lu.single import lu, lu_factor, lu_residual

__all__ = ["lu_factor", "lu", "lu_residual", "clu_factor", "clu_residual",
           "clu_25d"]
