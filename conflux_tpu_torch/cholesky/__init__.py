from conflux_tpu_torch.cholesky.single import cholesky, cholesky_residual
from conflux_tpu_torch.cholesky.stepped import cholesky_stepped

__all__ = ["cholesky", "cholesky_residual", "cholesky_stepped"]
