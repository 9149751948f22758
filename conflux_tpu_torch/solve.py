"""Right-hand-side solves from computed factors.

PyTorch counterpart of `conflux_tpu/solve.py`: factor once with
`lu_factor` or `cholesky`, then solve A x = b for b of shape [n] or
[n, k].
"""

from __future__ import annotations

import torch

from conflux_tpu_torch.precision import ieee_fp32


@ieee_fp32()
def lu_solve(F: torch.Tensor, perm: torch.Tensor,
             b: torch.Tensor) -> torch.Tensor:
    """Solve A x = b given (F, perm) from lu_factor (A[perm] = L U)."""
    n = F.shape[1]
    squeeze = b.dim() == 1
    B = b[:, None] if squeeze else b
    # solve_triangular reads only the named triangle of the merged factor
    Y = torch.linalg.solve_triangular(F[:n], B[perm], upper=False,
                                      unitriangular=True)
    X = torch.linalg.solve_triangular(F[:n], Y, upper=True)
    return X[:, 0] if squeeze else X


@ieee_fp32()
def cho_solve(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve A x = b given the lower Cholesky factor L (A = L L^T)."""
    squeeze = b.dim() == 1
    B = b[:, None] if squeeze else b
    Y = torch.linalg.solve_triangular(L, B, upper=False)
    X = torch.linalg.solve_triangular(L.T, Y, upper=True)
    return X[:, 0] if squeeze else X
