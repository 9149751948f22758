from conflux_tpu_torch.lu.cp25d import clu_25d
from conflux_tpu_torch.lu.csingle import clu_factor, clu_residual
from conflux_tpu_torch.lu.single import lu, lu_factor, lu_residual
from conflux_tpu_torch.lu.stepped import lu_factor_stepped

__all__ = ["lu_factor", "lu", "lu_residual", "clu_factor", "clu_residual",
           "clu_25d", "lu_factor_stepped"]
