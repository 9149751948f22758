"""Parity of the port's distributed Cholesky (conflux_tpu_torch/cholesky/
p25d.py) with the JAX reference's `cholesky_25d` on its 8-device CPU
mesh, on the same numpy inputs.

The port's ranks run as processes of a gloo world on the CPU
(`launch.run_ranks`, tests/torch_ranks.py), one world per grid shape,
started once per file; JAX runs here in the parent. Every variant name
('fori', 'unrolled', 'lookahead', 'windowed', 'crout') runs against the
JAX variant of the same name on (2, 2, 2), with an identity-padded input
through `pcholesky`, and on (1, 2, 4) with v = 6 (a zero-padded last
update slice).

Tolerance, as the single-device parity tests (tests/test_torch_cholesky.py):
both sides are IEEE fp32 at 'highest' in the same operation order up to
the summation order of the products, so max|L - L_jax| <= 1e-6 max|L_jax|.
Every factor must meet the reference's gate ||A - L L^T|| / (N ||A||)
<= 1e-6, and the factor's blocks off layer 0 hold zeros.
"""

import numpy as np
import pytest
import torch

import torch_ranks
from conflux_tpu.cholesky.p25d import cholesky_25d as jcholesky_25d
from conflux_tpu.cholesky.p25d import pcholesky as jpcholesky
from conflux_tpu.grid import make_grid as jmake_grid
from conflux_tpu.layout import BlockCyclic as JBlockCyclic
from conflux_tpu.layout import distribute as jdistribute
from conflux_tpu.layout import pad_like as jpad_like
from conflux_tpu.layout import undistribute as jundistribute
from conflux_tpu_torch import validation
from conflux_tpu_torch.errors import ConfluxError
from conflux_tpu_torch.launch import run_ranks

GATE = 1e-6
L_TOL = 1e-6

# (n, v, variant, api) per grid shape
CASES = {
    (2, 2, 2): [(48, 8, "fori", "cholesky_25d"),
                (48, 8, "unrolled", "cholesky_25d"),
                (48, 8, "lookahead", "cholesky_25d"),
                (48, 8, "windowed", "cholesky_25d"),
                (48, 8, "crout", "cholesky_25d"),
                (40, 8, "crout", "pcholesky"),
                (40, 8, None, "pcholesky")],
    (1, 2, 4): [(36, 6, "unrolled", "cholesky_25d"),
                (36, 6, "crout", "cholesky_25d")],
}
IDS = [(shape, i) for shape, cases in CASES.items()
       for i in range(len(cases))]


def _spd(shape, i):
    n = CASES[shape][i][0]
    X = np.random.default_rng(2000 + 10 * sum(shape) + i).standard_normal(
        (n, n))
    return (X @ X.T + n * np.eye(n)).astype(np.float32)


@pytest.fixture(scope="module")
def port():
    """The port's results per grid shape: one gloo world on the CPU per
    shape runs all of that shape's cases, at the first test that needs
    it."""
    worlds = {}

    def get(shape):
        if shape not in worlds:
            cases = [dict(A=_spd(shape, i), v=c[1], variant=c[2], api=c[3])
                     for i, c in enumerate(CASES[shape])]
            worlds[shape] = run_ranks(int(np.prod(shape)),
                                      torch_ranks.cholesky_cases, shape,
                                      cases, device="cpu", timeout=300)
        return worlds[shape]

    return get


def _jax(shape, i):
    n, v, variant, api = CASES[shape][i]
    A = _spd(shape, i)
    grid = jmake_grid(shape)
    if api == "pcholesky" and variant is None:
        # the auto variant on both sides ('lookahead' below N = 8192)
        return np.asarray(jpcholesky(A, grid, v=v)), A
    if api == "pcholesky":
        # JAX's pcholesky takes no variant: factor the padded input with
        # it and crop, as the port's pcholesky does
        desc = JBlockCyclic.create(n, n, v, grid)
        L = jundistribute(jcholesky_25d(jdistribute(A, desc), desc,
                                        "highest", variant), desc)
        return np.asarray(L)[:n, :n], A
    desc = JBlockCyclic.create(n, n, v, grid)
    L = jcholesky_25d(jdistribute(A, desc), desc, "highest", variant)
    return np.asarray(jundistribute(L, desc)), np.asarray(jpad_like(A, desc))


@pytest.mark.parametrize("shape,i", IDS,
                         ids=[f"{'x'.join(map(str, s))}-{CASES[s][i][2]}-"
                              f"{CASES[s][i][3]}-n{CASES[s][i][0]}"
                              for s, i in IDS])
def test_cholesky_25d_matches_jax(port, shape, i):
    ranks = port(shape)
    Lj, Ap = _jax(shape, i)
    got = ranks[0]["cases"][i]
    Lt = got["L"]
    assert all(r["jax_free"] for r in ranks)
    assert all(r["cases"][i]["L"] is None for r in ranks[1:])
    assert all(r["cases"][i]["zero_off_layer0"] for r in ranks)
    assert Lt.dtype == np.float32 and Lt.shape == Lj.shape
    np.testing.assert_array_equal(Lt, np.tril(Lt))
    assert np.abs(Lt - Lj).max() / np.abs(Lj).max() <= L_TOL
    assert validation.cholesky_residual_dense(Ap, Lt) <= GATE


@pytest.mark.parametrize("dtype", [torch.float16, torch.int32])
def test_cholesky_25d_other_dtypes_raise(dtype):
    # bfloat16 and float64 run (tests/test_torch_dtypes.py,
    # tests/test_torch_f64.py)
    from conflux_tpu_torch.cholesky.p25d import cholesky_25d
    from conflux_tpu_torch.errors import ErrorCode
    from conflux_tpu_torch.grid import make_grid
    from conflux_tpu_torch.layout import BlockCyclic

    desc = BlockCyclic.create(16, 16, 8, make_grid((1, 1, 1), device="cpu"))
    with pytest.raises(ConfluxError, match="float32, float64 or") as e:
        cholesky_25d(torch.zeros(16, 16, dtype=dtype), desc)
    assert e.value.code == ErrorCode.INVALID_TYPE


def test_cholesky_25d_one_rank_runs_single_device(rng):
    # a (1, 1, 1) grid needs no process group and runs _potrf_flat
    from conflux_tpu_torch.cholesky.p25d import pcholesky
    from conflux_tpu_torch.cholesky.single import cholesky
    from conflux_tpu_torch.grid import make_grid

    X = rng.standard_normal((40, 40))
    A = torch.from_numpy((X @ X.T + 40 * np.eye(40)).astype(np.float32))
    L = pcholesky(A, make_grid((1, 1, 1), device="cpu"), v=8)
    assert torch.equal(L, cholesky(A, v=8, scheme="flat"))
