"""Single-device complex LU with partial pivoting.

PyTorch counterpart of `conflux_tpu/lu/csingle.py`, the complex64 (and,
as the JAX package's x64 mode, complex128) instantiation of the crout
scheme of lu/single._getrf_crout: each panel is updated once by a big-K
complex product (ops/cplx.cschur_dot, real products of the parts), the
winners get their full U row at selection time, and the live rows compact
every step. Pivot scoring is LAPACK cgetrf's cabs1 = |re| + |im|. The
panel is ops/cplx.cpanel_factor's per-column loop: the JAX package has no
Pallas kernel on this path, so there is none to port.
"""

from __future__ import annotations

import numpy as np
import torch

from conflux_tpu_torch.errors import ConfluxError, ErrorCode
from conflux_tpu_torch.ops.cplx import (
    cpanel_factor,
    cschur_dot,
    ctrsm_left_lower_unit,
)
from conflux_tpu_torch.precision import ieee_fp32


def _unit_lower_c(lu: torch.Tensor) -> torch.Tensor:
    n = lu.shape[0]
    return torch.tril(lu, -1) + torch.eye(n, dtype=lu.dtype, device=lu.device)


def check_complex(A: torch.Tensor, entry: str):
    """Raise INVALID_TYPE unless A is complex64 or complex128."""
    if A.dtype not in (torch.complex64, torch.complex128):
        raise ConfluxError(ErrorCode.INVALID_TYPE,
                           f"{entry} takes complex64 or complex128, not "
                           f"{A.dtype}")


@ieee_fp32()
def clu_factor(A: torch.Tensor, v: int = 128, method: str = "4m"):
    """Complex LU with partial pivoting: (F, perm) with
    A[perm] = unit_lower(F) @ triu(F), lu_factor's contract. `method`
    picks the complex product ('4m' or '3m', ops/cplx.cschur_dot). A is
    never modified."""
    m, n = A.shape
    if m < n:
        raise ConfluxError(ErrorCode.INVALID_SHAPE,
                           "clu_factor expects m >= n")
    check_complex(A, "clu_factor")
    dev = A.device
    R = A                  # the live rows; replaced, never written
    origin = torch.arange(m, device=dev)
    F = torch.zeros((m, n), dtype=A.dtype, device=dev)
    perm = torch.zeros(m, dtype=torch.int64, device=dev)
    for k in range(0, n, v):
        w = min(v, n - k)
        m_r = R.shape[0]
        panel = R[:, k:k + w]
        if k > 0:
            panel = panel - cschur_dot(R[:, :k], F[:k, k:k + w], method)
        piv, _, M = cpanel_factor(
            panel, torch.ones(m_r, dtype=torch.bool, device=dev), w)
        lu_top = M[piv]
        Rpiv = R[piv]                         # [w, n] row gather
        if k > 0:
            F[k:k + w, :k] = Rpiv[:, :k]
        F[k:k + w, k:k + w] = lu_top
        if k + w < n:
            rhs = Rpiv[:, k + w:]
            if k > 0:
                rhs = rhs - cschur_dot(Rpiv[:, :k], F[:k, k + w:], method)
            F[k:k + w, k + w:] = ctrsm_left_lower_unit(_unit_lower_c(lu_top),
                                                       rhs)
        perm[k:k + w] = origin[piv]
        if m_r > w:
            # sorted live rows without a host sync: pivot rows sort last;
            # gather first, then write the panel's multipliers into the
            # fresh buffer (R, which may be the caller's A, is never
            # written)
            keep = torch.ones(m_r, dtype=torch.bool, device=dev)
            keep[piv] = False
            rows = torch.arange(m_r, device=dev)
            live_idx = torch.sort(torch.where(keep, rows, m_r)).values[
                :m_r - w]
            R = R[live_idx]
            R[:, k:k + w] = M[live_idx]
            origin = origin[live_idx]
    if m > n:
        F[n:] = R
        perm[n:] = origin
    return F, perm


def clu_residual(A, F, perm) -> float:
    """||PA - LU||_F / (N ||A||_F) in complex128 on the host."""
    def host(X):
        if isinstance(X, torch.Tensor):
            X = X.detach().cpu().numpy()
        return np.asarray(X, np.complex128)

    A, F = host(A), host(F)
    perm = (perm.detach().cpu().numpy() if isinstance(perm, torch.Tensor)
            else np.asarray(perm))
    m, n = F.shape
    L = np.tril(F, -1) + np.eye(m, n)
    U = np.triu(F[:n])
    R = A[perm] - L @ U
    return float(np.linalg.norm(R) / (n * np.linalg.norm(A)))
