"""Parity of the PyTorch port's solves (conflux_tpu_torch/solve.py) with the
JAX reference (conflux_tpu/solve.py): the same numpy factors and right-hand
sides go to both. Both run two fp32 triangular solves, so the solutions
agree to 1e-5 normwise; a solve from the port's own factors must also give
||A x - b|| / (||A|| ||x||) <= 1e-6 in float64.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import conflux_tpu.solve as jsolve
import conflux_tpu_torch
from conflux_tpu_torch import solve as tsolve
from conflux_tpu_torch.cholesky.single import cholesky
from conflux_tpu_torch.lu.single import lu_factor

TOL = 1e-5
GATE = 1e-6
N = 96


def _normwise(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / np.abs(ref).max()


def _solve_residual(A, x, b):
    A, x, b = (np.asarray(t, np.float64) for t in (A, x, b))
    return np.linalg.norm(A @ x - b) / (np.linalg.norm(A) * np.linalg.norm(x))


def _rhs(rng, cols):
    shape = (N,) if cols is None else (N, cols)
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("cols", [None, 3])
@pytest.mark.parametrize("scheme", ["crout", "flat"])
def test_lu_solve_matches_jax(rng, scheme, cols):
    A = rng.standard_normal((N, N)).astype(np.float32)
    b = _rhs(rng, cols)
    F, perm = lu_factor(torch.from_numpy(A), v=32, scheme=scheme)
    x = tsolve.lu_solve(F, perm, torch.from_numpy(b))
    assert tuple(x.shape) == b.shape
    xj = jsolve.lu_solve(jnp.asarray(F.numpy()), jnp.asarray(perm.numpy()),
                         jnp.asarray(b))
    assert _normwise(x.numpy(), xj) <= TOL
    assert _solve_residual(A, x.numpy(), b) <= GATE


@pytest.mark.parametrize("cols", [None, 3])
def test_cho_solve_matches_jax(rng, cols):
    X = rng.standard_normal((N, N))
    A = (X @ X.T + N * np.eye(N)).astype(np.float32)
    b = _rhs(rng, cols)
    L = cholesky(torch.from_numpy(A), v=32)
    x = tsolve.cho_solve(L, torch.from_numpy(b))
    assert tuple(x.shape) == b.shape
    xj = jsolve.cho_solve(jnp.asarray(L.numpy()), jnp.asarray(b))
    assert _normwise(x.numpy(), xj) <= TOL
    assert _solve_residual(A, x.numpy(), b) <= GATE


def test_package_exports_solves():
    assert conflux_tpu_torch.lu_solve is tsolve.lu_solve
    assert conflux_tpu_torch.cho_solve is tsolve.cho_solve
