from conflux_tpu_torch.cholesky.single import cholesky, cholesky_residual

__all__ = ["cholesky", "cholesky_residual"]
