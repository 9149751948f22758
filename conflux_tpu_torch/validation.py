"""Correctness gates: ||PA - LU||_F / (N ||A||_F), ||A - L L^T||_F /
(N ||A||_F) and pivot growth.

PyTorch counterpart of the single-device gates of
`conflux_tpu/validation.py` (the reference's miniapp gate,
examples/conflux_miniapp.cpp:480-499).
"""

from __future__ import annotations

import numpy as np
import torch

from conflux_tpu_torch.precision import ieee_fp32


def lu_residual_dense(A, F, perm) -> float:
    """||PA - LU||_F / (N ||A||_F) on host arrays, in float64."""
    A = np.asarray(A, np.float64)
    F = np.asarray(F, np.float64)
    perm = np.asarray(perm)
    m, n = F.shape
    L = np.tril(F, -1) + np.eye(m, n)
    U = np.triu(F[:n])
    R = A[perm] - L @ U
    return float(np.linalg.norm(R) / (n * np.linalg.norm(A)))


@ieee_fp32()
def lu_residual_blocked(A: torch.Tensor, F: torch.Tensor, perm: torch.Tensor,
                        block: int = 4096) -> float:
    """FULL ||PA - LU||_F / (N ||A||_F) on the factors' device, for factors
    too large for a dense float64 reconstruction: U = triu(F[:n]) is formed
    once, and A and L stream through in `block`-row slices, so the device
    holds A, F, U and two row blocks. The reconstruction is IEEE fp32
    (`precision.ieee_fp32`, whatever the caller set); the block sums
    accumulate in float64 on the device, and the one host read is the
    final scalar."""
    F = torch.as_tensor(F)
    dev = F.device
    A = torch.as_tensor(A, device=dev)
    perm = torch.as_tensor(perm, device=dev).long()
    m, n = F.shape
    U = torch.triu(F[:n]).float()
    c = torch.arange(n, device=dev)[None, :]
    r2 = torch.zeros((), dtype=torch.float64, device=dev)
    a2 = torch.zeros((), dtype=torch.float64, device=dev)
    for r0 in range(0, m, block):
        r1 = min(r0 + block, m)
        r = torch.arange(r0, r1, device=dev)[:, None]
        # unit-lower mask of factor rows r0..r1: strict-lower entries kept,
        # unit diagonal, zeros above
        Lb = torch.where(c < r, F[r0:r1].float(), 0.0)
        Lb += ((c == r) & (r < n)).float()
        Arows = A[perm[r0:r1]].float()
        Rb = Arows - Lb @ U
        r2 += (Rb * Rb).sum().double()
        a2 += (Arows * Arows).sum().double()
    return float(torch.sqrt(r2) / (n * torch.sqrt(a2)))


def cholesky_residual_dense(A, L) -> float:
    """||A - L L^T||_F / (N ||A||_F) on host arrays, in float64."""
    A = np.asarray(A, np.float64)
    L = np.asarray(L, np.float64)
    n = A.shape[0]
    return float(np.linalg.norm(A - L @ L.T) / (n * np.linalg.norm(A)))


@ieee_fp32()
def cholesky_residual_blocked(A: torch.Tensor, L: torch.Tensor,
                              block: int = 4096) -> float:
    """FULL ||A - L L^T||_F / (N ||A||_F) on the factor's device, for
    factors too large for a dense float64 reconstruction: L (lower
    triangular, as `cholesky` returns it) stays where it is and A streams
    through in `block`-row slices, so the device holds A, L and two row
    blocks. IEEE fp32 reconstruction (`precision.ieee_fp32`), float64
    block sums on the device, one host read of the final scalar."""
    L = torch.as_tensor(L)
    dev = L.device
    A = torch.as_tensor(A, device=dev)
    n = L.shape[0]
    r2 = torch.zeros((), dtype=torch.float64, device=dev)
    a2 = torch.zeros((), dtype=torch.float64, device=dev)
    for r0 in range(0, n, block):
        r1 = min(r0 + block, n)
        Arows = A[r0:r1].float()
        Rb = Arows - L[r0:r1].float() @ L.float().T
        r2 += (Rb * Rb).sum().double()
        a2 += (Arows * Arows).sum().double()
    return float(torch.sqrt(r2) / (n * torch.sqrt(a2)))


def growth_factor(A, F) -> float:
    """Pivot growth ||U||_max / ||A||_max, the CALU stability diagnostic."""
    A = torch.as_tensor(A)
    U = torch.triu(torch.as_tensor(F))
    return float(U.abs().max() / max(float(A.abs().max()), 1e-30))
