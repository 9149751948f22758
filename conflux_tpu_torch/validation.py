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

from conflux_tpu_torch.interop import resolve_device
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


def _as_tensor(X) -> torch.Tensor:
    """X as a tensor where it lies: a numpy array is wrapped, not copied."""
    return X if isinstance(X, torch.Tensor) else torch.from_numpy(
        np.asarray(X))


def _gate_device(F, device) -> torch.device:
    """Where a blocked gate computes: `device` if given, else the factor's
    device when it is a tensor, else (a numpy factor) the card."""
    if device is None:
        device = F.device if isinstance(F, torch.Tensor) else "cuda"
    return resolve_device(device)


@ieee_fp32()
def lu_residual_blocked(A, F, perm, block: int = 4096,
                        device=None) -> float:
    """FULL ||PA - LU||_F / (N ||A||_F) for factors too large for a dense
    float64 reconstruction. A and F may each lie on the host (numpy or a
    CPU tensor) or on a card; the reconstruction runs on `device` (None:
    the factor's device for a tensor factor, the card for a numpy one).
    U = triu(F[:n]) is formed there once, in `block`-row slices, and the
    rows of L and of A[perm] stream through in `block`-row slices, so the
    device holds U and two row blocks besides whatever of A and F already
    lies there. The reconstruction is IEEE fp32 (`precision.ieee_fp32`,
    whatever the caller set) for a float32 factor, bf16 products with
    f32 accumulation for a bf16 factor (the JAX package's bf16 branch: U
    stays bf16), f64 for a float64 factor and complex128 for a complex
    one; the block sums accumulate in float64 on the device, and the one
    host read is the final scalar."""
    dev = _gate_device(F, device)
    A, F = _as_tensor(A), _as_tensor(F)
    cdt = _recon_dtype(F)
    fdt = F.dtype if F.dtype == torch.bfloat16 else cdt
    perm = torch.as_tensor(perm).long().to(A.device)
    m, n = F.shape
    U = torch.empty((n, n), dtype=fdt, device=dev)
    for r0 in range(0, n, block):
        r1 = min(r0 + block, n)
        U[r0:r1] = torch.triu(F[r0:r1, :n].to(dev, fdt), r0)
    c = torch.arange(n, device=dev)[None, :]
    r2 = torch.zeros((), dtype=torch.float64, device=dev)
    a2 = torch.zeros((), dtype=torch.float64, device=dev)
    for r0 in range(0, m, block):
        r1 = min(r0 + block, m)
        r = torch.arange(r0, r1, device=dev)[:, None]
        # unit-lower mask of factor rows r0..r1: strict-lower entries kept,
        # unit diagonal, zeros above
        Lb = torch.where(c < r, F[r0:r1].to(dev, fdt), 0.0)
        Lb += ((c == r) & (r < n)).to(fdt)
        Arows = A.index_select(0, perm[r0:r1]).to(dev, cdt)
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
def cholesky_residual_blocked(A, L, block: int = 4096,
                              device=None) -> float:
    """FULL ||A - L L^T||_F / (N ||A||_F) for factors too large for a
    dense float64 reconstruction. A and L (lower triangular, as
    `cholesky` returns it) may each lie on the host or on a card; the
    reconstruction runs on `device` (None: the factor's device for a
    tensor factor, the card for a numpy one). L is copied there in
    `block`-row slices unless it lies there already in its gate dtype,
    and A's rows stream through in `block`-row slices, so the device
    holds L and two row blocks. IEEE fp32 reconstruction
    (`precision.ieee_fp32`) for a float32 factor, bf16 products with f32
    accumulation for a bf16 one, f64 for a float64 one; float64 block
    sums on the device, one host read of the final scalar."""
    dev = _gate_device(L, device)
    A, L = _as_tensor(A), _as_tensor(L)
    cdt = _recon_dtype(L)
    ldt = L.dtype if L.dtype == torch.bfloat16 else cdt
    n = L.shape[0]
    if L.device != dev or L.dtype != ldt:
        Ld = torch.empty((n, n), dtype=ldt, device=dev)
        for r0 in range(0, n, block):
            Ld[r0:r0 + block].copy_(L[r0:r0 + block])
        L = Ld
    r2 = torch.zeros((), dtype=torch.float64, device=dev)
    a2 = torch.zeros((), dtype=torch.float64, device=dev)
    for r0 in range(0, n, block):
        r1 = min(r0 + block, n)
        Arows = A[r0:r1].to(dev, cdt)
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
