"""The port's named-axis collectives (conflux_tpu_torch/comm.py), its rank
launcher (launch.py) and the communication volume of its rank programs,
held to the JAX package.

One gloo world of 8 ranks on the CPU (`launch.run_ranks`,
tests/torch_ranks.py) runs, on a (2, 2, 2) grid:
  * every collective of `comm.Comm` (psum over each axis subset,
    all_gather over each axis, ppermute over 'x', psum_scatter over 'x'
    along each dim) on integer-valued float32 slices, so sums are exact
    in any order: each must equal what `jax.lax`'s collective gives under
    `shard_map` on the JAX mesh, bit for bit;
  * one LU (tournament, 'unrolled' at rowpart 0 and 2) and one Cholesky
    ('unrolled', 'crout') factorization each, with every rank's record of
    the collectives it issued.

The records are turned into ring volumes (elements moved, summed over all
ranks; tests/test_spec_comm.py's convention: a psum of E elements over g
ranks moves 2 E (g - 1) per group, an all_gather E (g - 1) g, a tiled
psum_scatter E (g - 1), a ppermute E per pair) and held, class by class,
to the communication model, in the port's copy (conflux_tpu_torch/spec.py,
held to `conflux_tpu.spec` bit for bit by tests/test_torch_dist_rest.py):
the LU's to `tournament_lu_np`'s CommVolume exactly; the Cholesky's
right-looking program to the closed forms of
tests/test_spec_comm.py:352 with each step's live window (the port slices
rows [r0:] at every step, as JAX's unrolled variant does), its crout
program to `model_cholesky_comm_volume(..., 'crout')` exactly.
"""

from fractions import Fraction

import jax
import numpy as np
import pytest
from jax import shard_map
from jax.sharding import PartitionSpec as P

import torch_ranks
from conflux_tpu.grid import make_grid as jmake_grid
from conflux_tpu_torch.comm import SUBSETS, coords_of, rank_of
from conflux_tpu_torch.launch import run_ranks
from conflux_tpu_torch.spec import model_cholesky_comm_volume, \
    tournament_lu_np

SHAPE = (2, 2, 2)
SIZES = dict(zip("xyz", SHAPE))
PAIRS = (((0, 1), (1, 0)), ((0, 1),), ((1, 1),))
N, V = 64, 8                        # tests/test_spec_comm.py's LU size
LU_RUNS = (("unrolled", 0), ("unrolled", 2))
CHOL_VARIANTS = ("unrolled", "crout")


def _slices():
    """[P, 4, 6] integer-valued float32: one [4, 6] slice per rank."""
    rng = np.random.default_rng(7)
    return rng.integers(-50, 50, (8, 4, 6)).astype(np.float32)


def _lu_input():
    return np.random.default_rng(0).standard_normal((N, N)).astype(np.float32)


def _spd_input():
    B = np.random.default_rng(0).standard_normal((N, N))
    return (B @ B.T + N * np.eye(N)).astype(np.float32)


@pytest.fixture(scope="module")
def world():
    return run_ranks(8, torch_ranks.comm_world, SHAPE, (_slices(), PAIRS),
                     (_lu_input(), _spd_input(), V, LU_RUNS, CHOL_VARIANTS),
                     device="cpu", timeout=300)


def _jax_collective(fn):
    """fn(t) under shard_map on the (2, 2, 2) JAX mesh, for each rank's
    slice t of _slices(); returns [P, ...] in the port's rank order."""
    mesh = jmake_grid(SHAPE).mesh
    X = _slices().reshape(SHAPE + (4, 6))

    def body(x):
        return fn(x[0, 0, 0])[None, None, None]

    out = shard_map(body, mesh=mesh, in_specs=P("x", "y", "z"),
                    out_specs=P("x", "y", "z"))(X)
    out = np.asarray(out)
    return out.reshape((8,) + out.shape[3:])


def _ops():
    ops = [(("psum", axes), lambda t, a=axes: jax.lax.psum(t, a))
           for axes in SUBSETS]
    ops += [(("all_gather", ax), lambda t, a=ax: jax.lax.all_gather(t, a))
            for ax in "xyz"]
    ops += [(("ppermute", pairs),
             lambda t, p=pairs: jax.lax.ppermute(t, "x", list(p)))
            for pairs in PAIRS]
    ops += [(("psum_scatter", d),
             lambda t, d=d: jax.lax.psum_scatter(t, "x", scatter_dimension=d,
                                                 tiled=True))
            for d in (0, 1)]
    return ops


def _op_id(key):
    return "-".join(map(str, key)).replace(" ", "")


def test_rank_coordinates_follow_the_jax_mesh():
    # rank = (pi * Py + pj) * Pz + pz (conflux_tpu/grid.py:188-190)
    devs = np.arange(8).reshape(SHAPE)
    for pi, pj, pz in np.ndindex(*SHAPE):
        assert rank_of((pi, pj, pz), SHAPE) == devs[pi, pj, pz]
        assert coords_of(int(devs[pi, pj, pz]), SHAPE) == (pi, pj, pz)


@pytest.mark.parametrize("key,fn", _ops(), ids=[_op_id(k) for k, _ in _ops()])
def test_collective_matches_jax(world, key, fn):
    want = _jax_collective(fn)
    for r, got in enumerate(world):
        np.testing.assert_array_equal(got["comm"][key], want[r])
    assert all(got["comm"]["jax_free"] for got in world)


def test_every_call_is_recorded(world):
    recs = world[0]["comm"]["records"]
    assert [(r.op, r.axes) for r in recs] == (
        [("psum", a) for a in SUBSETS]
        + [("all_gather", (a,)) for a in "xyz"]
        + [("ppermute", ("x",))] * len(PAIRS)
        + [("psum_scatter", ("x",))] * 2)
    assert all(r.shape == (4, 6) and r.dtype == "float32" for r in recs)
    assert [r.pairs for r in recs if r.op == "ppermute"] == [2, 1, 1]


def _ring(rec) -> Fraction:
    """This rank's share of the ring volume of one recorded collective;
    summed over the ranks of the grid, the totals of
    tests/test_spec_comm.py's jaxpr walk."""
    g = int(np.prod([SIZES[a] for a in rec.axes]))
    E = int(np.prod(rec.shape))
    share = {"psum": Fraction(2 * E * (g - 1), g),
             "all_gather": Fraction(E * (g - 1)),
             "psum_scatter": Fraction(E * (g - 1), g),
             "ppermute": Fraction(E * rec.pairs, g)}
    return share[rec.op]


def _lu_class(rec, mr_ok):
    """The CommVolume class of one collective of the right-looking LU
    (tests/test_spec_comm.py:125-181)."""
    l, Nl = -(-V // SIZES["z"]), N // SIZES["y"]
    shp = rec.shape
    if rec.op == "psum" and rec.axes == ("z",) and shp[1:] == (V,):
        return "psum_z"
    if rec.op == "psum" and rec.axes == ("x", "z") and shp == (V, Nl):
        return "row_gather_xz"
    if rec.op == "psum" and rec.axes == ("x",) and shp == (N,):
        return "rebalance_x"
    if rec.op == "psum" and rec.axes == ("y",) and shp in ((V,), (V, V)):
        return "pivot_bcast_y"
    if (rec.op == "psum" and rec.axes == ("y",) and len(shp) == 2
            and shp[1] == l and mr_ok(shp[0])):
        return "panel_slice_y"
    if rec.op == "ppermute" and rec.axes == ("x",):
        return "tournament_x"
    if rec.op == "psum_scatter" and rec.axes == ("x",):
        return "rebalance_x"
    raise AssertionError(f"unmodeled collective {rec}")


@pytest.mark.parametrize("variant,rowpart", LU_RUNS)
def test_lu_volumes_match_comm_model(world, variant, rowpart):
    Px, Py, Pz = SHAPE
    _, _, want = tournament_lu_np(_lu_input().astype(np.float64), V, Px, Pz,
                                  Py, rowpart=rowpart)
    got, ppermutes = {}, 0
    for r in world:
        recs = r["volume"][("lu", variant, rowpart)]
        for rec in recs:
            c = _lu_class(rec, lambda m: V <= m <= N // Px)
            got[c] = got.get(c, 0) + _ring(rec)
        ppermutes = sum(rec.op == "ppermute" for rec in recs)
    for field in ("psum_z", "tournament_x", "pivot_bcast_y",
                  "row_gather_xz", "panel_slice_y", "rebalance_x"):
        assert got.get(field, 0) == getattr(want, field), field
    assert (want.rebalance_x > 0) == (rowpart > 0)
    # one ppermute of the candidates' values and one of their rows per
    # butterfly round
    assert ppermutes == 2 * want.rounds_x


def _cholesky_volumes(world, variant):
    got = {}
    for r in world:
        for rec in r["volume"][("cholesky", variant)]:
            key = (rec.op, rec.axes)
            got[key] = got.get(key, 0) + _ring(rec)
    return got


def test_cholesky_rightlook_volumes_match_closed_forms(world):
    Px, Py, Pz = SHAPE
    Ml, l = N // Px, -(-V // Pz)
    want = {("psum", ("z",)): 0, ("psum", ("x", "y")): 0,
            ("psum", ("y",)): 0, ("all_gather", ("x",)): 0}
    for k in range(N // V):
        mr = Ml - (k // Px) * V           # the live window of step k
        want[("psum", ("z",))] += 2 * mr * V * (Pz - 1) * Px * Py
        want[("psum", ("x", "y"))] += 2 * V * V * (Px * Py - 1) * Pz
        want[("psum", ("y",))] += 2 * mr * l * (Py - 1) * Px * Pz
        want[("all_gather", ("x",))] += mr * l * (Px - 1) * Px * Py * Pz
    assert _cholesky_volumes(world, "unrolled") == want
    # the JAX model of the full-height (fori) schedule bounds it
    full = model_cholesky_comm_volume(N, V, Px, Py, Pz)
    assert sum(want.values()) < full["total"]


def test_cholesky_crout_volumes_match_model(world):
    Px, Py, Pz = SHAPE
    want = model_cholesky_comm_volume(N, V, Px, Py, Pz, variant="crout")
    got = _cholesky_volumes(world, "crout")
    assert got == {("psum", ("x", "z")): want["slab_xz"],
                   ("psum", ("y", "z")): want["col_yz"],
                   ("psum", ("x",)): want["a00_x"]}


def test_run_ranks_names_the_failing_rank():
    with pytest.raises(RuntimeError, match="rank 1 of 2 failed") as e:
        run_ranks(2, torch_ranks.fail_on_rank, 1, device="cpu", timeout=120)
    assert "fails on purpose" in str(e.value)


def test_run_ranks_times_out():
    # the timeout also bounds the ranks' rendezvous: it leaves room for two
    # processes to start on a loaded machine
    with pytest.raises(TimeoutError, match=r"ranks \[1\] of 2"):
        run_ranks(2, torch_ranks.outlive, 600, device="cpu", timeout=60)
