from conflux_tpu_torch.lu.single import lu, lu_factor, lu_residual

__all__ = ["lu_factor", "lu", "lu_residual"]
