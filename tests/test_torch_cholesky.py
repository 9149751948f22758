"""Parity of the PyTorch port's single-device Cholesky
(conflux_tpu_torch/cholesky/single.py), its tile factorization
(`ops/tri.potrf_tile`) and the Cholesky residual gates with the JAX
reference, on the same numpy inputs.

Tolerances, normwise (max|diff| <= tol * max|ref|):
  * 'highest' and potrf_tile: both sides are IEEE fp32 with the same
    operation order up to summation order (1e-6; measured ~1e-7);
  * 'high': the port splits operands into bf16x3 explicitly while the JAX
    CPU backend does not split (5e-6; measured ~5e-7).
Every factor must also meet the reference's gate ||A - L L^T|| / (N ||A||)
<= 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import conflux_tpu.cholesky.single as jchol
import conflux_tpu.ops.tri as jtri
import conflux_tpu.validation as jvalidation
import conflux_tpu_torch
from conflux_tpu_torch import validation
from conflux_tpu_torch.cholesky import single as tchol
from conflux_tpu_torch.errors import ConfluxError, ErrorCode
from conflux_tpu_torch.ops import tri as ttri

GATE = 1e-6
TOL = {"highest": 1e-6, "high": 5e-6}


def _spd(rng, n):
    X = rng.standard_normal((n, n))
    return (X @ X.T + n * np.eye(n)).astype(np.float32)


def _normwise(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize("precision", ["highest", "high"])
@pytest.mark.parametrize("scheme", ["flat", "recursive"])
@pytest.mark.parametrize("n,v", [(64, 16), (160, 32), (200, 64)])
def test_cholesky_matches_jax(rng, n, v, scheme, precision):
    A = _spd(rng, n)
    Lj = np.asarray(jchol.cholesky(jnp.asarray(A), v=v, precision=precision,
                                   scheme=scheme))
    Lt = tchol.cholesky(torch.from_numpy(A), v=v, precision=precision,
                        scheme=scheme)
    assert Lt.dtype == torch.float32 and tuple(Lt.shape) == (n, n)
    Lt = Lt.numpy()
    np.testing.assert_array_equal(Lt, np.tril(Lt))
    assert _normwise(Lt, Lj) <= TOL[precision]
    assert validation.cholesky_residual_dense(A, Lt) <= GATE


@pytest.mark.parametrize("n", [32, 96, 200])
def test_potrf_tile_matches_jax(rng, n):
    # n > 64 crosses lu_nopivot's block boundary (the forced inter-block
    # update)
    A = _spd(rng, n)
    ref = np.asarray(jtri.potrf_tile(jnp.asarray(A)))
    got = ttri.potrf_tile(torch.from_numpy(A)).numpy()
    assert _normwise(got, ref) <= TOL["highest"]


def test_potrf_tile_zeroes_nonpositive_columns():
    # a non-SPD tile degrades to a finite factor, as in the reference
    A = torch.tensor([[4.0, 2.0], [2.0, -3.0]])
    L = ttri.potrf_tile(A)
    Lj = np.asarray(jtri.potrf_tile(jnp.asarray(A.numpy())))
    assert bool(torch.isfinite(L).all())
    np.testing.assert_allclose(L.numpy(), Lj, rtol=1e-6, atol=0)
    assert float(L[1, 1]) == 0.0


def test_cholesky_residuals_match_jax(rng):
    n = 96
    A = _spd(rng, n)
    L = tchol.cholesky(torch.from_numpy(A), v=32)
    Ln = L.numpy()
    dense = validation.cholesky_residual_dense(A, Ln)
    assert dense == jvalidation.cholesky_residual_dense(A, Ln)
    res_t = float(tchol.cholesky_residual(torch.from_numpy(A), L))
    res_j = float(jchol.cholesky_residual(jnp.asarray(A), jnp.asarray(Ln)))
    # fp32 reconstructions track the float64 value to their own rounding
    assert res_t <= GATE
    for res in (res_t, res_j):
        assert 0.5 * dense <= res <= 2 * dense, (res, dense)


@pytest.mark.parametrize("block", [40, 4096])
def test_cholesky_residual_blocked_matches_jax(rng, block):
    n = 128
    A = _spd(rng, n)
    L = tchol.cholesky(torch.from_numpy(A), v=32, precision="high")
    dense = validation.cholesky_residual_dense(A, L.numpy())
    blocked = validation.cholesky_residual_blocked(torch.from_numpy(A), L,
                                                   block=block)
    jblocked = jvalidation.cholesky_residual_blocked(A, L.numpy(),
                                                     block=block)
    assert blocked <= GATE
    for res in (blocked, jblocked):
        assert 0.5 * dense <= res <= 2 * dense, (res, dense)


@pytest.mark.parametrize("scheme", ["flat", "recursive"])
def test_cholesky_leaves_input_unchanged(rng, scheme):
    # flat updates one copy of A in place; the caller's A is never written
    A = torch.from_numpy(_spd(rng, 80))
    A0 = A.clone()
    L = tchol.cholesky(A, v=32, scheme=scheme)
    assert torch.equal(A, A0)
    assert validation.cholesky_residual_dense(A0, L) <= GATE


@pytest.mark.parametrize("precision,routed", [("high", True),
                                              ("bf16", False),
                                              ("highest", False)])
def test_flat_cholesky_runs_its_panel_update_through_k2(rng, monkeypatch,
                                                        precision, routed):
    # 'high' sends each step's panel update (k > 0) through
    # ops/gemm.sub_matmul_bigk, K2 on the card, with B the transposed view
    # F[k:k+w, :k].T; on the CPU its plain version is the expression it
    # replaced, bit for bit
    n, v = 100, 32
    A = torch.from_numpy(_spd(rng, n))
    seen = []
    inner = tchol.sub_matmul_bigk

    def spy(R, X, Y, mode):
        seen.append((mode, Y.stride(0) == 1 and Y.stride(1) != 1))
        return inner(R, X, Y, mode)

    monkeypatch.setattr(tchol, "sub_matmul_bigk", spy)
    L = tchol.cholesky(A, v=v, precision=precision)
    steps = -(-n // v)
    assert seen == ([(precision, True)] * (steps - 1) if routed else [])
    monkeypatch.setattr(tchol, "sub_matmul_bigk",
                        lambda R, X, Y, p: R - ttri.schur_dot(X, Y, p))
    assert torch.equal(L, tchol.cholesky(A, v=v, precision=precision))


@pytest.mark.parametrize("dtype", [torch.float16, torch.int32])
def test_cholesky_rejects_unported_dtypes(dtype):
    # bfloat16 and float64 run (tests/test_torch_dtypes.py,
    # tests/test_torch_f64.py)
    with pytest.raises(ConfluxError, match="float32, float64 or") as e:
        tchol.cholesky(torch.eye(8, dtype=dtype))
    assert e.value.code == ErrorCode.INVALID_TYPE


def test_cholesky_rejects_bad_shape_and_scheme():
    with pytest.raises(ConfluxError) as e:
        tchol.cholesky(torch.ones(4, 8))
    assert e.value.code == ErrorCode.INVALID_SHAPE
    with pytest.raises(ConfluxError, match="unknown scheme"):
        tchol.cholesky(torch.eye(8), scheme="stepped")


def test_package_exports_cholesky():
    # `conflux_tpu_torch.cholesky` is the subpackage, as in the JAX package
    from conflux_tpu_torch.cholesky import cholesky, cholesky_residual

    assert cholesky is tchol.cholesky
    assert cholesky_residual is tchol.cholesky_residual
    assert conflux_tpu_torch.cholesky_residual_blocked is \
        validation.cholesky_residual_blocked
