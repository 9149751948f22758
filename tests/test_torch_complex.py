"""Parity of the port's complex64 path (ops/cplx.py, lu/csingle.py,
lu/cp25d.py) with the JAX package's (conflux_tpu/ops/cplx.py,
lu/csingle.py, lu/cp25d.py), on the same numpy inputs.

Both packages form every complex product from real float32 products of
the parts ('4m', '3m') in the same decomposition, IEEE fp32 on the CPU:
they differ in the products' summation order only, so products and TRSMs
are held to 1e-5 of max(|a| @ |b|) (or of max|X|). The panel and the
factorizations are held to: pivots identical at these seeds, the factors
within 1e-4 of max|F| (the rank-1 updates and divisions of two runtimes'
complex arithmetic round differently in the last f32 bits, and elimination
carries that on), and the JAX package's gate ||PA - LU||_F / (N ||A||_F)
< 1e-6 (tests/test_complex.py:100, 164), distributed on the four grids
of tests/test_complex.py:145-150, in one gloo world of 8 CPU ranks
(tests/torch_ranks.py), with the port's SUMMA gate on every rank of the
grid. complex128 runs against the JAX x64 mode in tests/test_torch_f64.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ranks
from conflux_tpu.grid import make_grid as jmake_grid
from conflux_tpu.layout import BlockCyclic as JBlockCyclic
from conflux_tpu.layout import distribute as jdistribute
from conflux_tpu.layout import pad_like as jpad_like
from conflux_tpu.layout import undistribute as jundistribute
from conflux_tpu.lu.cp25d import clu_25d as jclu_25d
from conflux_tpu.lu.csingle import clu_factor as jclu_factor
from conflux_tpu.ops import cplx as jcplx
from conflux_tpu_torch.errors import ConfluxError, ErrorCode
from conflux_tpu_torch.launch import run_ranks
from conflux_tpu_torch.lu import clu_factor, clu_residual, lu_factor
from conflux_tpu_torch.ops import cplx

OP_TOL = 1e-5
F_TOL = 1e-4
GATE = 1e-6
# the grids of tests/test_complex.py:145-150: (shape, m, n, v)
GRIDS = [((2, 2, 2), 64, 64, 8), ((3, 2, 1), 96, 96, 8),
         ((2, 2, 1), 96, 64, 8), ((1, 2, 4), 64, 64, 8)]


def _crand(seed, *shape):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _t(X):
    return torch.from_numpy(np.ascontiguousarray(X))


def _rel(got, want, scale):
    return float(np.abs(np.asarray(got) - np.asarray(want)).max()) / scale


@pytest.mark.parametrize("method", ["4m", "3m"])
def test_cschur_dot_matches_jax(method):
    A, B = _crand(1, 48, 32), _crand(2, 32, 40)
    got = cplx.cschur_dot(_t(A), _t(B), method).numpy()
    want = np.asarray(jcplx.cschur_dot(jnp.asarray(A), jnp.asarray(B),
                                       method))
    assert got.dtype == np.complex64
    scale = float((np.abs(A) @ np.abs(B)).max())
    assert _rel(got, want, scale) <= OP_TOL


def test_cabs1_is_lapack_convention():
    z = torch.tensor([3 - 4j, -1 + 2j, 0j], dtype=torch.complex64)
    np.testing.assert_array_equal(cplx.cabs1(z).numpy(), [7.0, 3.0, 0.0])


@pytest.mark.parametrize("m,w", [(64, 16), (200, 32)])
def test_cpanel_factor_matches_jax(m, w):
    P = _crand(3, m, w)
    avail = np.ones(m, bool)
    avail[::9] = False
    pt, okt, Mt = cplx.cpanel_factor(_t(P), torch.from_numpy(avail), w)
    pj, okj, Mj = jcplx.cpanel_factor(jnp.asarray(P), jnp.asarray(avail), w)
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
    # the rows the factorization reads: live multipliers and merged rows
    rows = avail.copy()
    rows[pt.numpy()] = True
    Mj = np.asarray(Mj)
    assert _rel(Mt.numpy()[rows], Mj[rows], np.abs(Mj[rows]).max()) <= F_TOL


def _unit_lower(seed, n):
    """A unit-lower complex triangle with off-diagonals scaled by 0.1:
    random triangles are exponentially ill-conditioned."""
    L = np.tril(_crand(seed, n, n), -1) * 0.1
    return (L + np.eye(n)).astype(np.complex64)


@pytest.mark.parametrize("n", [24, 80])
def test_ctrsm_left_lower_unit_matches_jax(n):
    L, B = _unit_lower(4, n), _crand(5, n, 20)
    got = cplx.ctrsm_left_lower_unit(_t(L), _t(B)).numpy()
    want = np.asarray(jcplx.ctrsm_left_lower_unit(jnp.asarray(L),
                                                  jnp.asarray(B)))
    assert _rel(got, want, np.abs(want).max()) <= OP_TOL
    np.testing.assert_allclose(L.astype(np.complex128) @ got, B, atol=1e-4)


@pytest.mark.parametrize("n", [24, 80])
def test_ctrsm_right_upper_matches_jax(n):
    U = (_unit_lower(6, n).T * (2.0 + np.arange(n))[:, None]).astype(
        np.complex64)
    B = _crand(7, 30, n)
    got = cplx.ctrsm_right_upper(_t(B), _t(U)).numpy()
    want = np.asarray(jcplx.ctrsm_right_upper(jnp.asarray(B),
                                              jnp.asarray(U)))
    assert _rel(got, want, np.abs(want).max()) <= OP_TOL
    np.testing.assert_allclose(got @ U.astype(np.complex128), B, atol=1e-4)


@pytest.mark.parametrize("m,n,v,method", [(64, 64, 8, "3m"),
                                          (96, 64, 16, "4m"),
                                          (128, 128, 32, "4m")])
def test_clu_factor_matches_jax(m, n, v, method):
    A = _crand(8 + m + v, m, n)
    Ft, pt = clu_factor(_t(A), v, method)
    Fj, pj = jclu_factor(jnp.asarray(A), v=v, method=method)
    Fj = np.asarray(Fj)
    assert Ft.dtype == torch.complex64
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    assert _rel(Ft.numpy(), Fj, np.abs(Fj).max()) <= F_TOL
    assert clu_residual(A, Ft, pt) < GATE


def test_clu_factor_keeps_its_input_and_handles_zero_pivots():
    A = _t(_crand(9, 32, 32))
    A0 = A.clone()
    clu_factor(A, 8)
    assert torch.equal(A, A0)
    F, _ = clu_factor(torch.zeros(16, 16, dtype=torch.complex64), 4)
    assert bool(torch.isfinite(torch.view_as_real(F)).all())


def test_complex_entry_points_check_their_dtype():
    with pytest.raises(ConfluxError, match="clu_factor") as e:
        lu_factor(torch.eye(8, dtype=torch.complex64))
    assert e.value.code == ErrorCode.INVALID_TYPE
    with pytest.raises(ConfluxError) as e:
        clu_factor(torch.eye(8, dtype=torch.float32))
    assert e.value.code == ErrorCode.INVALID_TYPE


@pytest.fixture(scope="module")
def world():
    """clu_25d on each grid of GRIDS (and '3m' on the first), in one gloo
    world of 8 CPU ranks."""
    cases = [dict(kind="clu", shape=shape, A=_crand(20 + i, m, n),
                  dtype="complex64", v=v, method="4m")
             for i, (shape, m, n, v) in enumerate(GRIDS)]
    shape, m, n, v = GRIDS[0]
    cases.append(dict(kind="clu", shape=shape, A=_crand(20, m, n),
                      dtype="complex64", v=v, method="3m"))
    return run_ranks(8, torch_ranks.dtype_cases, cases, device="cpu",
                     timeout=600)


@pytest.mark.parametrize("i", range(len(GRIDS) + 1),
                         ids=[f"{'x'.join(map(str, s))}-{m}x{n}"
                              for s, m, n, _ in GRIDS] + ["2x2x2-3m"])
def test_clu_25d_matches_jax(world, i):
    shape, m, n, v = GRIDS[i % len(GRIDS)]
    method = "3m" if i == len(GRIDS) else "4m"
    A = _crand(20 + i % len(GRIDS), m, n)
    desc = JBlockCyclic.create(m, n, v, jmake_grid(shape))
    F, pj = jclu_25d(jdistribute(jnp.asarray(A), desc), desc, method)
    Fj = np.asarray(jundistribute(F, desc))
    Ap = np.asarray(jpad_like(A, desc))
    assert all(r["jax_free"] for r in world)
    got = world[0]["cases"][i]
    P = int(np.prod(shape))
    assert got["dtype"] == "torch.complex64"
    for r in world[:P]:
        np.testing.assert_array_equal(r["cases"][i]["perm"], got["perm"])
    np.testing.assert_array_equal(got["perm"], np.asarray(pj))
    assert _rel(got["F"], Fj, np.abs(Fj).max()) <= F_TOL
    assert clu_residual(Ap, got["F"], got["perm"]) < GATE
    gates = {r["cases"][i]["gate"] for r in world[:P]}
    assert len(gates) == 1 and got["gate"] < GATE
