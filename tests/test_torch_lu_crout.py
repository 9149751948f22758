"""Parity of the port's left-looking (crout) LU rank program
(conflux_tpu_torch/lu/p25d.py `_local_lu_25d_crout`) with the JAX
reference's `lu_25d(..., unroll="crout")` on its 8-device CPU mesh, on the
same numpy inputs.

One gloo world of 8 ranks on the CPU (`launch.run_ranks`,
tests/torch_ranks.py) runs every case, each on its grid: the grids and
pivotings of tests/test_lu_dist.py:314-324 ((2, 2, 2) tournament and
full; (4, 2, 1) gather; (2, 4, 1) tournament; (1, 2, 4) tournament and
gather, the Px == 1 fused panel; (1, 4, 2) tournament), a tall 96 x 64
case, and the crout and 'fori' programs at rowpart = 0 on one input. JAX
runs here in the parent.

At 'highest' both packages run IEEE fp32 in the same operation order up
to the summation order of the products, so the pivots must be identical
and F is held to JAX's F within 1e-4 of max|F|: the crout's big-K
products reassociate longer sums than the right-looking program's
(tests/test_torch_lu_dist.py holds those at 2e-5). Every factor must
meet the reference's gate ||PA - LU|| / (N ||A||) <= 1e-6. Each
tournament case's record of collectives, turned into ring volumes, must
equal the port's `spec.model_comm_volume(..., variant="crout")` class by
class.
"""

from fractions import Fraction
from types import SimpleNamespace
from unittest import mock

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
from conflux_tpu_torch.dispatch import choose_variant
from conflux_tpu_torch.grid import make_grid
from conflux_tpu_torch.launch import run_ranks
from conflux_tpu_torch.layout import BlockCyclic, distribute, undistribute
from conflux_tpu_torch.lu import p25d
from conflux_tpu_torch.spec import model_comm_volume

GATE = 1e-6
F_TOL = 1e-4

# (shape, m, n, v, pivoting, variant, rowpart)
CASES = [
    ((2, 2, 2), 64, 64, 8, "tournament", "crout", None),
    ((2, 2, 2), 64, 64, 8, "full", "crout", None),
    ((4, 2, 1), 64, 64, 8, "gather", "crout", None),
    ((2, 4, 1), 64, 64, 8, "tournament", "crout", None),
    ((1, 2, 4), 64, 64, 8, "tournament", "crout", None),
    ((1, 2, 4), 64, 64, 8, "gather", "crout", None),
    ((1, 4, 2), 64, 64, 8, "tournament", "crout", None),
    ((2, 2, 2), 96, 64, 8, "tournament", "crout", None),
    # at rowpart = 0 the crout's row layout is the right-looking 'fori'
    # program's, so the tournament groups and the pivots are the same
    ((2, 2, 2), 96, 96, 8, "tournament", "crout", 0),
    ((2, 2, 2), 96, 96, 8, "tournament", "fori", None),
]
PARITY = range(9)          # the crout cases
ROWPART0 = (8, 9)


def _matrix(i):
    _, m, n = CASES[i][:3]
    seed = 2000 + (8 if i == 9 else i)      # the rowpart-0 pair: one input
    return np.random.default_rng(seed).standard_normal((m, n)).astype(
        np.float32)


@pytest.fixture(scope="module")
def world():
    cases = [dict(shape=c[0], A=_matrix(i), v=c[3], pivoting=c[4],
                  variant=c[5], rowpart=c[6]) for i, c in enumerate(CASES)]
    return run_ranks(8, torch_ranks.crout_cases, cases, device="cpu",
                     timeout=300)


def _jax(i):
    shape, _, _, v, pivoting, variant, rowpart = CASES[i]
    A = _matrix(i)
    desc = JBlockCyclic.create(A.shape[0], A.shape[1], v, jmake_grid(shape))
    F, perm = jlu_25d(jdistribute(A, desc), desc, pivoting, "highest",
                      variant, rowpart=rowpart)
    return (np.asarray(jundistribute(F, desc)), np.asarray(perm),
            np.asarray(jpad_like(A, desc)))


def _id(i):
    shape, m, n, _, pivoting, _, rowpart = CASES[i]
    return f"{'x'.join(map(str, shape))}-{pivoting}-{m}x{n}-rowpart{rowpart}"


@pytest.mark.parametrize("i", PARITY, ids=[_id(i) for i in PARITY])
def test_crout_matches_jax(world, i):
    Fj, pj, Ap = _jax(i)
    got = world[0]["cases"][i]
    Ft, pt = got["F"], got["perm"]
    assert all(r["jax_free"] for r in world)
    for r in world:
        np.testing.assert_array_equal(r["cases"][i]["perm"], pt)
    assert all(r["cases"][i]["F"] is None for r in world[1:])
    assert pt.dtype == np.int64 and Ft.shape == Ap.shape
    np.testing.assert_array_equal(np.sort(pt), np.arange(Ap.shape[0]))
    np.testing.assert_array_equal(pt, pj)
    assert np.abs(Ft - Fj).max() / np.abs(Fj).max() <= F_TOL
    assert validation.lu_residual_dense(Ap, Ft, pt) <= GATE


def test_crout_rowpart0_pivots_equal_the_right_looking_program(world):
    crout, fori = (world[0]["cases"][i] for i in ROWPART0)
    np.testing.assert_array_equal(crout["perm"], fori["perm"])
    A = _matrix(ROWPART0[0])
    for got in (crout, fori):
        assert validation.lu_residual_dense(A, got["F"], got["perm"]) <= GATE


def _ring(rec, sizes) -> Fraction:
    """This rank's share of the ring volume of one recorded collective
    (tests/test_torch_comm.py's convention)."""
    g = int(np.prod([sizes[a] for a in rec.axes]))
    E = int(np.prod(rec.shape))
    share = {"psum": Fraction(2 * E * (g - 1), g),
             "all_gather": Fraction(E * (g - 1)),
             "psum_scatter": Fraction(E * (g - 1), g),
             "ppermute": Fraction(E * rec.pairs, g)}
    return share[rec.op]


def _crout_class(rec, prev, v, N, sizes):
    """The CommVolume class of one collective of the crout program
    (tournament pivoting, square N); prev is the collective before it."""
    Px, Py = sizes["x"], sizes["y"]
    shp, ax = rec.shape, rec.axes
    if rec.op == "psum" and ax == ("y", "z") and shp[1:] == (v,):
        return "panel_asm_yz"
    if (Px == 1 and rec.op == "psum" and ax == ("y",) and shp == (v, v)
            and prev.axes == ("x", "z")):
        # the fused panel's lu00, right after the pivot rows
        return "pivot_bcast_y"
    if rec.op == "psum" and ax == ("y",) and shp[1:] == (v,):
        return "uslab_y"
    if rec.op == "all_gather" and ax == ("x",) and shp[1:] == (v,):
        return "uslab_ag_x"
    if rec.op == "psum" and ax == ("x", "z") and shp == (v, N // Py):
        return "row_gather_xz"
    if rec.op == "all_gather" and ax == ("y",) and shp[0] == v:
        return "lpiv_ag_y"
    if rec.op == "psum" and ax == ("x",) and shp == (N,):
        return "rebalance_x"
    if rec.op == "psum" and ax == ("x",) and shp[0] == v:
        return "u12_corr_x"
    if rec.op == "psum_scatter" and ax == ("x",):
        return "rebalance_x"
    if rec.op == "ppermute" and ax == ("x",):
        return "tournament_x"
    raise AssertionError(f"unmodeled collective {rec}")


MODELED = [i for i in PARITY
           if CASES[i][4] == "tournament" and CASES[i][1] == CASES[i][2]]


@pytest.mark.parametrize("i", MODELED, ids=[_id(i) for i in MODELED])
def test_crout_volumes_match_comm_model(world, i):
    shape, _, n, v, _, _, rowpart = CASES[i]
    Px, Py, Pz = shape
    if rowpart is None:
        rowpart = p25d.crout_rowpart_default(Px, n // v)
    sizes = dict(zip("xyz", shape))
    got = {}
    for r in world:
        recs = r["cases"][i]["records"]
        for prev, rec in zip([None] + recs, recs):
            c = _crout_class(rec, prev, v, n, sizes)
            got[c] = got.get(c, 0) + _ring(rec, sizes)
    want = model_comm_volume(n, v, Px, Pz, Py, rowpart=rowpart,
                             variant="crout")
    for field in ("panel_asm_yz", "uslab_y", "uslab_ag_x", "lpiv_ag_y",
                  "u12_corr_x", "row_gather_xz", "pivot_bcast_y",
                  "tournament_x", "rebalance_x", "psum_z", "panel_slice_y"):
        assert got.get(field, 0) == getattr(want, field), field


def test_crout_one_rank_none_matches_jax(rng):
    # 'none' pivoting on a (1, 1, 1) grid runs the rank program itself
    # (the other pivotings take the single-device scheme of
    # `lu.single.auto_scheme`)
    A = (rng.standard_normal((48, 48)) + 48 * np.eye(48)).astype(np.float32)
    desc = BlockCyclic.create(48, 48, 8, make_grid((1, 1, 1), device="cpu"))
    F, perm = p25d.lu_25d(distribute(A, desc), desc, "none", "highest",
                          "crout")
    jdesc = JBlockCyclic.create(48, 48, 8, jmake_grid((1, 1, 1)))
    Fj, pj = jlu_25d(jdistribute(A, jdesc), jdesc, "none", "highest",
                     "crout")
    Fj = np.asarray(jundistribute(Fj, jdesc))
    np.testing.assert_array_equal(perm.numpy(), np.asarray(pj))
    F = undistribute(F, desc).numpy()
    assert np.abs(F - Fj).max() / np.abs(Fj).max() <= F_TOL
    assert validation.lu_residual_dense(A, F, perm.numpy()) <= GATE


def test_auto_variant_crout_runs_instead_of_raising():
    # dispatch picks 'crout' for a (1, 1, 1) grid at N >= 16384, where
    # 'none' pivoting runs the rank program; the port raised there. The
    # rank program itself is held to JAX above; here the descriptor is
    # full size, so it is replaced by a stand-in that records its call.
    grid = make_grid((1, 1, 1), device="cpu")
    desc = BlockCyclic.create(16384, 16384, 2048, grid)
    assert choose_variant(desc, "lu") == "crout"
    G = torch.zeros(1).expand(desc.Ml, desc.Nl)      # no memory behind it
    done = SimpleNamespace(args=None)

    def crout(*args):
        done.args = args
        return "F", "perm"

    with mock.patch.object(p25d, "_local_lu_25d_crout", crout):
        assert p25d.lu_25d(G, desc, "none") == ("F", "perm")
    assert done.args[:3] == (desc, "none", "highest")
