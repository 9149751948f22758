"""conflux-tpu on PyTorch and CUDA: the port of `conflux_tpu` to an NVIDIA
H100.

The JAX package `conflux_tpu` stays the reference; this package has its
module layout and function names, and imports torch, numpy and the
standard library only. So far it holds the single-device LU with partial
pivoting in its crout, flat and recursive schemes (`lu.single`), the
single-device Cholesky (`cholesky.single`), the solves (`solve`), the
panel factorization (`ops.panel`, with the rank-1 block kernel K1 in
CUDA, `ops.cuda_panel`), the fused trailing update (`ops.gemm`, with K3
in CUDA, `ops.cuda_gemm`), the triangular layer (`ops.tri`) and the
residual gates (`validation`).
"""

__version__ = "0.1.0"

from conflux_tpu_torch.errors import ConfluxError, ErrorCode


def __getattr__(name):
    # the factorization API resolves lazily to keep `import` light
    import importlib

    lazy = {
        "lu_factor": "conflux_tpu_torch.lu.single",
        "lu_residual": "conflux_tpu_torch.lu.single",
        "lu_residual_blocked": "conflux_tpu_torch.validation",
        "cholesky_residual_blocked": "conflux_tpu_torch.validation",
        "lu_solve": "conflux_tpu_torch.solve",
        "cho_solve": "conflux_tpu_torch.solve",
    }
    if name in lazy:
        return getattr(importlib.import_module(lazy[name]), name)
    raise AttributeError(name)


__all__ = ["ConfluxError", "ErrorCode", "lu_factor", "lu_residual",
           "lu_residual_blocked", "cholesky_residual_blocked",
           "lu_solve", "cho_solve"]
