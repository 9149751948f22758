"""Correctness gates: ||PA - LU||_F / (N ||A||_F), ||A - L L^T||_F /
(N ||A||_F) and pivot growth.

PyTorch counterpart of `conflux_tpu/validation.py` (the reference's
miniapp gate, examples/conflux_miniapp.cpp:480-499). The distributed
factors are gated where they lie: `lu_residual_dist` and
`cholesky_residual_dist` run the SUMMA plane of `pgemm` over the ranks'
blocks, and only the final scalar reaches the host.
"""

from __future__ import annotations

import numpy as np
import torch

from conflux_tpu_torch.ops.tri import _mm_f32acc
from conflux_tpu_torch.precision import ieee_fp32


def _recon_dtype(F: torch.Tensor):
    """The dtype a blocked gate reconstructs in: f64 for a float64 factor,
    complex128 for a complex one (the JAX package's complex gate is
    complex128), f32 otherwise (a bf16 factor's products accumulate in
    f32)."""
    if F.is_complex():
        return torch.complex128
    return torch.float64 if F.dtype == torch.float64 else torch.float32


def sum_sq(X: torch.Tensor) -> torch.Tensor:
    """sum |X|^2 in float64 (both parts of a complex X)."""
    if X.is_complex():
        X = torch.view_as_real(X)
    return (X.double() ** 2).sum()


def _product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in the gate's arithmetic: bf16 operands (a bf16 factor, kept
    bf16 so the gate does not double its footprint) with f32
    accumulation, as the JAX package's gates form it; other dtypes
    exactly as they are (IEEE fp32 under the pin, or f64)."""
    if a.dtype == torch.bfloat16:
        return _mm_f32acc(a, b)
    return a @ b


def _host(X, dtype):
    """A host array of `dtype`; a bf16 tensor is read as float32 first."""
    if isinstance(X, torch.Tensor):
        X = X.detach().cpu()
        if X.dtype == torch.bfloat16:
            X = X.float()
        X = X.numpy()
    return np.asarray(X, dtype)


def lu_residual_dense(A, F, perm) -> float:
    """||PA - LU||_F / (N ||A||_F) on host arrays, in float64."""
    A = _host(A, np.float64)
    F = _host(F, np.float64)
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
    (`precision.ieee_fp32`, whatever the caller set) for a float32
    factor, bf16 products with f32 accumulation for a bf16 factor (the
    JAX package's bf16 branch: U stays bf16), f64 for a float64 factor
    and complex128 for a complex one; the block sums accumulate in float64
    on the device, and the one host read is the final scalar."""
    F = torch.as_tensor(F)
    dev = F.device
    cdt = _recon_dtype(F)
    fdt = F.dtype if F.dtype == torch.bfloat16 else cdt
    A = torch.as_tensor(A, device=dev)
    perm = torch.as_tensor(perm, device=dev).long()
    m, n = F.shape
    U = torch.triu(F[:n]).to(fdt)
    c = torch.arange(n, device=dev)[None, :]
    r2 = torch.zeros((), dtype=torch.float64, device=dev)
    a2 = torch.zeros((), dtype=torch.float64, device=dev)
    for r0 in range(0, m, block):
        r1 = min(r0 + block, m)
        r = torch.arange(r0, r1, device=dev)[:, None]
        # unit-lower mask of factor rows r0..r1: strict-lower entries kept,
        # unit diagonal, zeros above
        Lb = torch.where(c < r, F[r0:r1].to(fdt), 0.0)
        Lb += ((c == r) & (r < n)).to(fdt)
        Arows = A[perm[r0:r1]].to(cdt)
        Rb = Arows - _product(Lb, U)
        r2 += sum_sq(Rb)
        a2 += sum_sq(Arows)
    return float(torch.sqrt(r2) / (n * torch.sqrt(a2)))


def cholesky_residual_dense(A, L) -> float:
    """||A - L L^T||_F / (N ||A||_F) on host arrays, in float64."""
    A = _host(A, np.float64)
    L = _host(L, np.float64)
    n = A.shape[0]
    return float(np.linalg.norm(A - L @ L.T) / (n * np.linalg.norm(A)))


@ieee_fp32()
def cholesky_residual_blocked(A: torch.Tensor, L: torch.Tensor,
                              block: int = 4096) -> float:
    """FULL ||A - L L^T||_F / (N ||A||_F) on the factor's device, for
    factors too large for a dense float64 reconstruction: L (lower
    triangular, as `cholesky` returns it) stays where it is and A streams
    through in `block`-row slices, so the device holds A, L and two row
    blocks. IEEE fp32 reconstruction (`precision.ieee_fp32`) for a
    float32 factor, bf16 products with f32 accumulation for a bf16 one,
    f64 for a float64 one; float64 block sums on the device, one host read
    of the final scalar."""
    L = torch.as_tensor(L)
    dev = L.device
    cdt = _recon_dtype(L)
    if L.dtype != torch.bfloat16:
        L = L.to(cdt)
    A = torch.as_tensor(A, device=dev)
    n = L.shape[0]
    r2 = torch.zeros((), dtype=torch.float64, device=dev)
    a2 = torch.zeros((), dtype=torch.float64, device=dev)
    for r0 in range(0, n, block):
        r1 = min(r0 + block, n)
        Arows = A[r0:r1].to(cdt)
        Rb = Arows - _product(L[r0:r1], L.T)
        r2 += sum_sq(Rb)
        a2 += sum_sq(Arows)
    return float(torch.sqrt(r2) / (n * torch.sqrt(a2)))


def lu_residual_dist(G, F, perm, desc) -> float:
    """||PA - LU||_F / (N ||A||_F) of a distributed LU, from this rank's
    blocks G of A and F of the factor (`lu.p25d.lu_25d`) and the pivot
    vector: computed on the ranks' devices by SUMMA
    (`pgemm.plu_residual_25d`), the same on every rank, None on an idle
    rank. Every rank of the grid must call it."""
    from conflux_tpu_torch.pgemm import plu_residual_25d

    return plu_residual_25d(G, F, perm, desc)


def cholesky_residual_dist(G, Lg, desc) -> float:
    """||A - L L^T||_F / (N ||A||_F) of a distributed Cholesky factor,
    from this rank's blocks G of A and Lg of L (`cholesky.p25d`), by SUMMA
    (`pgemm.pchol_residual_25d`); None on an idle rank. Every rank of the
    grid must call it."""
    from conflux_tpu_torch.pgemm import pchol_residual_25d

    return pchol_residual_25d(G, Lg, desc)


def growth_factor(A, F) -> float:
    """Pivot growth ||U||_max / ||A||_max, the CALU stability diagnostic."""
    A = torch.as_tensor(A)
    U = torch.triu(torch.as_tensor(F))
    return float(U.abs().max() / max(float(A.abs().max()), 1e-30))
