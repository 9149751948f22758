"""Single-device Cholesky.

PyTorch counterpart of `conflux_tpu/cholesky/single.py`. The flat scheme
is left-looking and updates one copy of A in place: each column panel is
updated by one [m_k, k] x [k, w] product against all previous panels,
then factored (a w x w `potrf_tile`, K1 in forced mode on the card, and a
blocked TRSM). The recursive scheme splits in halves.
"""

from __future__ import annotations

import torch

from conflux_tpu_torch.errors import ConfluxError, ErrorCode
from conflux_tpu_torch.ops.tri import potrf_tile, schur_dot, trsm_right_lower_t


def _potrf_flat(A: torch.Tensor, v: int,
                precision: str = "highest") -> torch.Tensor:
    """Left-looking blocked Cholesky on one copy of A, updated in place
    (A itself is never written). Exactly N^3/3 product FLOPs."""
    n = A.shape[0]
    F = A.clone()
    for k in range(0, n, v):
        w = min(v, n - k)
        col = F[k:, k:k + w]
        if k > 0:
            col = col - schur_dot(F[k:, :k], F[k:k + w, :k].T, precision)
        L11 = potrf_tile(col[:w])
        F[k:k + w, k:k + w] = L11
        if k + w < n:
            F[k + w:, k:k + w] = trsm_right_lower_t(col[w:], L11,
                                                    method="invert")
    return F.tril_()


def _potrf_rec(A: torch.Tensor, v: int,
               precision: str = "highest") -> torch.Tensor:
    n = A.shape[0]
    if n <= v:
        return potrf_tile(A)
    n1 = max(v, (n // 2 // v) * v)
    L11 = _potrf_rec(A[:n1, :n1], v, precision)
    L21 = trsm_right_lower_t(A[n1:, :n1], L11)
    S = A[n1:, n1:] - schur_dot(L21, L21.T, precision)
    L22 = _potrf_rec(S, v, precision)
    top = torch.cat([L11, torch.zeros((n1, n - n1), dtype=A.dtype,
                                      device=A.device)], dim=1)
    bot = torch.cat([L21, L22], dim=1)
    return torch.cat([top, bot], dim=0)


def cholesky(A: torch.Tensor, v: int = 128, precision: str = "highest",
             scheme: str = "flat") -> torch.Tensor:
    """Lower Cholesky factor of an SPD matrix. scheme: 'flat'
    (left-looking, in place on one copy of A) or 'recursive'. precision
    ('highest', 'high', 'bf16') sets the big update products; tiles and
    TRSMs stay fp32. A is never modified."""
    if A.dim() != 2 or A.shape[0] != A.shape[1]:
        raise ConfluxError(ErrorCode.INVALID_SHAPE,
                           f"cholesky expects a square matrix, got "
                           f"{tuple(A.shape)}")
    if A.dtype != torch.float32:
        raise ConfluxError(
            ErrorCode.INVALID_TYPE,
            f"{A.dtype}: the PyTorch port factors float32 only so far "
            "(bf16 storage, f64 and complex are ROADMAP item 7)")
    if scheme == "flat":
        return _potrf_flat(A, v, precision)
    if scheme == "recursive":
        return _potrf_rec(A, v, precision)
    raise ConfluxError(ErrorCode.INVALID_SHAPE, f"unknown scheme {scheme!r}")


def cholesky_residual(A: torch.Tensor, L: torch.Tensor) -> torch.Tensor:
    """||A - L L^T||_F / (N ||A||_F) in IEEE fp32 on the factor's device
    (a 0-d tensor)."""
    n = L.shape[0]
    A = torch.as_tensor(A, device=L.device)
    return torch.linalg.norm(A - L @ L.T) / (n * torch.linalg.norm(A))
