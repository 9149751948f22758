"""Parity of the port's distributed LU (conflux_tpu_torch/lu/p25d.py) with
the JAX reference's `lu_25d` on its 8-device CPU mesh, on the same numpy
inputs.

The port's ranks run as processes of a gloo world on the CPU
(`launch.run_ranks`, tests/torch_ranks.py), one world per grid shape,
started once per file; JAX runs here in the parent. Grids: (2, 2, 2),
(2, 2, 1), (3, 2, 1) (non-power-of-two Px: the masked-psum broadcast
rounds of the butterfly, and pad slots in the row rebalance) and
(2, 1, 4) with v = 6 (v not a multiple of Pz: a zero-padded last update
slice). Every variant name runs against the JAX variant of the same name,
at the same `rowpart`.

At 'highest' both packages run IEEE fp32 in the same operation order up
to the summation order of the products, so the pivots must be identical
and F is held to the JAX F at the single-device parity tests' tolerance
(tests/test_torch_lu.py): 2e-5 of max|F|, the sum of two independent fp32
errors of ~1e-5 each. Every factor must meet the reference's gate
||PA - LU|| / (N ||A||) <= 1e-6 against the identity-padded input.
"""

import numpy as np
import pytest
import torch

import torch_ranks
from conflux_tpu.grid import make_grid as jmake_grid
from conflux_tpu.layout import BlockCyclic as JBlockCyclic
from conflux_tpu.layout import distribute as jdistribute
from conflux_tpu.layout import pad_like as jpad_like
from conflux_tpu.layout import undistribute as jundistribute
from conflux_tpu.lu.p25d import lu_25d as jlu_25d
from conflux_tpu_torch import validation
from conflux_tpu_torch.errors import ConfluxError
from conflux_tpu_torch.launch import run_ranks
from conflux_tpu_torch.lu.single import lu_factor

GATE = 1e-6
F_TOL = 2e-5

# (m, n, v, pivoting, variant, rowpart, api) per grid shape; 'none' runs
# on a diagonally dominant input (it is stable only there)
CASES = {
    (2, 2, 2): [
        (48, 48, 8, "tournament", "fori", None, "lu_25d"),
        (48, 48, 8, "tournament", "unrolled", 0, "lu_25d"),
        (48, 48, 8, "tournament", "unrolled", 1, "lu_25d"),
        (48, 48, 8, "tournament", "lookahead", None, "lu_25d"),
        (48, 48, 8, "tournament", "windowed", None, "lu_25d"),
        (48, 48, 8, "gather", "fori", None, "lu_25d"),
        (48, 48, 8, "full", "windowed", None, "lu_25d"),
        (48, 48, 8, "none", "unrolled", 1, "lu_25d"),
        (72, 48, 8, "tournament", "fori", None, "lu_25d"),
    ],
    (2, 2, 1): [
        (32, 32, 8, "tournament", "fori", None, "plu"),
        (32, 32, 8, "gather", "unrolled", 1, "lu_25d"),
        (32, 32, 8, "full", "lookahead", None, "lu_25d"),
        (32, 32, 8, "none", "fori", None, "plu"),
    ],
    (3, 2, 1): [
        (48, 48, 8, "tournament", "fori", None, "lu_25d"),
        (48, 48, 8, "tournament", "unrolled", 1, "lu_25d"),
        (48, 48, 8, "gather", "windowed", None, "lu_25d"),
        (56, 32, 8, "tournament", "windowed", None, "lu_25d"),
    ],
    (2, 1, 4): [
        (60, 60, 6, "tournament", "fori", None, "lu_25d"),
        (60, 60, 6, "tournament", "unrolled", 1, "lu_25d"),
    ],
}
IDS = [(shape, i) for shape, cases in CASES.items()
       for i in range(len(cases))]


def _matrix(shape, i):
    m, n, _, pivoting, _, _, _ = CASES[shape][i]
    rng = np.random.default_rng(1000 + 10 * sum(shape) + i)
    A = rng.standard_normal((m, n))
    if pivoting == "none":
        A += n * np.eye(m, n)
    return A.astype(np.float32)


@pytest.fixture(scope="module")
def port():
    """The port's results per grid shape: one gloo world on the CPU per
    shape runs all of that shape's cases, at the first test that needs
    it."""
    worlds = {}

    def get(shape):
        if shape not in worlds:
            cases = [dict(A=_matrix(shape, i), v=c[2], pivoting=c[3],
                          variant=c[4], rowpart=c[5], api=c[6])
                     for i, c in enumerate(CASES[shape])]
            worlds[shape] = run_ranks(int(np.prod(shape)),
                                      torch_ranks.lu_cases, shape, cases,
                                      device="cpu", timeout=300)
        return worlds[shape]

    return get


def _jax(shape, i):
    _, _, v, pivoting, variant, rowpart, _ = CASES[shape][i]
    A = _matrix(shape, i)
    grid = jmake_grid(shape)
    desc = JBlockCyclic.create(A.shape[0], A.shape[1], v, grid)
    F, perm = jlu_25d(jdistribute(A, desc), desc, pivoting, "highest",
                      variant, rowpart=rowpart)
    return (np.asarray(jundistribute(F, desc)), np.asarray(perm),
            np.asarray(jpad_like(A, desc)))


@pytest.mark.parametrize("shape,i", IDS,
                         ids=[f"{'x'.join(map(str, s))}-{'-'.join(map(str, CASES[s][i][3:6]))}"
                              f"-{CASES[s][i][0]}x{CASES[s][i][1]}"
                              for s, i in IDS])
def test_lu_25d_matches_jax(port, shape, i):
    ranks = port(shape)
    Fj, pj, Ap = _jax(shape, i)
    got = ranks[0]["cases"][i]
    Ft, pt = got["F"], got["perm"]
    assert all(r["jax_free"] for r in ranks)
    # every rank holds the same pivot vector; only rank 0 the dense factor
    for r in ranks:
        np.testing.assert_array_equal(r["cases"][i]["perm"], pt)
    assert all(r["cases"][i]["F"] is None for r in ranks[1:])
    assert pt.dtype == np.int64 and Ft.shape == Ap.shape
    np.testing.assert_array_equal(np.sort(pt), np.arange(Ap.shape[0]))
    np.testing.assert_array_equal(pt, pj)
    assert np.abs(Ft - Fj).max() / np.abs(Fj).max() <= F_TOL
    assert validation.lu_residual_dense(Ap, Ft, pt) <= GATE


def test_lu_25d_full_matches_single_device(port):
    # 'full' pivoting is exact partial pivoting: its pivots are the
    # single-device blocked LU's (tests/test_lu_dist.py:109 for JAX)
    shape, i = (2, 2, 1), 2
    got = port(shape)[0]["cases"][i]
    _, p = lu_factor(torch.from_numpy(_matrix(shape, i)), v=CASES[shape][i][2])
    np.testing.assert_array_equal(got["perm"], p.numpy())


def test_lu_25d_tall_tail_ascending(port):
    # the M - N rows never chosen close the pivot vector in ascending
    # original-row order (LAPACK trapezoid semantics)
    shape, i = (2, 2, 2), 8
    m, n = CASES[shape][i][:2]
    perm = port(shape)[0]["cases"][i]["perm"]
    assert perm.shape == (m + 8,) and np.all(np.diff(perm[n:]) > 0)


def test_lu_25d_one_rank_runs_single_device(rng):
    # a (1, 1, 1) grid needs no process group and runs the single-device
    # scheme lu_factor's 'auto' picks
    from conflux_tpu_torch.grid import make_grid
    from conflux_tpu_torch.lu.p25d import plu

    A = rng.standard_normal((40, 40)).astype(np.float32)
    F, perm = plu(A, make_grid((1, 1, 1), device="cpu"), v=8)
    Fs, ps = lu_factor(torch.from_numpy(A), v=8)
    assert torch.equal(perm, ps) and torch.equal(F, Fs)


@pytest.mark.parametrize("dtype", [torch.float16, torch.int32])
def test_lu_25d_other_dtypes_raise(dtype):
    # bfloat16 and float64 run (tests/test_torch_dtypes.py,
    # tests/test_torch_f64.py)
    from conflux_tpu_torch.errors import ErrorCode
    from conflux_tpu_torch.grid import make_grid
    from conflux_tpu_torch.layout import BlockCyclic
    from conflux_tpu_torch.lu.p25d import lu_25d

    desc = BlockCyclic.create(16, 16, 8, make_grid((1, 1, 1), device="cpu"))
    with pytest.raises(ConfluxError, match="float32, float64 or") as e:
        lu_25d(torch.zeros(16, 16, dtype=dtype), desc)
    assert e.value.code == ErrorCode.INVALID_TYPE
