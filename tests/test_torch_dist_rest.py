"""The rest of the port's distributed layer held to the JAX package on the
same numpy inputs: SUMMA `pgemm` and the distributed residual gates
(conflux_tpu_torch/pgemm.py, validation.py), `layout.retile` /
`redistribute`, the ScaLAPACK-style `pdgetrf` / `pdpotrf`
(scalapack.py), the profiler and the substep-profiled rank programs
(profiler.py, lu/profiled.py, cholesky/profiled.py), and the serial numpy
simulators and comm models (spec.py).

One gloo world of 8 ranks on the CPU (`launch.run_ranks`,
tests/torch_ranks.py `dist_rest_cases`) runs every distributed case, each
on its grid of the world (a grid of 4 leaves ranks 4-7 idle). JAX runs
here in the parent. Tolerances: pgemm within rtol 1e-4 / atol 1e-3 of
numpy and of JAX's pgemm (tests/test_pgemm.py); each distributed residual
<= 1e-6 and within a factor 3 of the residual of the gathered factor and
of JAX's residual of the same factor (both noise-level sums); retile and
the profiled programs bit for bit; pdgetrf / pdpotrf: the pivots and
ipiv equal to JAX's, the factors within 2e-5 of max|F| (the fp32
tolerance of tests/test_torch_lu_dist.py); the simulators bit for bit.
"""

import numpy as np
import pytest

import torch_ranks
from conflux_tpu import profiler as jprofiler
from conflux_tpu import spec as jspec
from conflux_tpu.grid import make_grid as jmake_grid
from conflux_tpu.layout import BlockCyclic as JBlockCyclic
from conflux_tpu.layout import distribute as jdistribute
from conflux_tpu.layout import pad_like as jpad_like
from conflux_tpu.layout import retile as jretile
from conflux_tpu.layout import undistribute as jundistribute
from conflux_tpu.pgemm import pchol_residual_25d as jpchol_residual_25d
from conflux_tpu.pgemm import pgemm as jpgemm
from conflux_tpu.pgemm import plu_residual_25d as jplu_residual_25d
from conflux_tpu.scalapack import pdgetrf as jpdgetrf
from conflux_tpu.scalapack import pdpotrf as jpdpotrf
from conflux_tpu_torch import profiler, spec, validation
from conflux_tpu_torch.errors import ConfluxError, ErrorCode
from conflux_tpu_torch.grid import make_grid
from conflux_tpu_torch.launch import run_ranks
from conflux_tpu_torch.layout import BlockCyclic, retile

GATE = 1e-6
F_TOL = 2e-5
N, V = 64, 8
PGEMM_SHAPES = ((2, 2, 1), (2, 2, 2), (4, 2, 1))
# (shape, m, n): square, padded (60 -> 64) and tall (72 x 48)
LU_GATES = (((2, 2, 1), 64, 64), ((2, 2, 2), 64, 64), ((2, 2, 2), 60, 60),
            ((2, 2, 2), 72, 48))
CHOL_GATES = (((2, 2, 1), 64), ((2, 2, 2), 64), ((2, 2, 2), 60))
# (src shape, src v, dst shape, dst v): a tile change, a tile change on a
# grid of Pz = 1 (tests/test_retile_ckpt.py), a grid change, and the
# (2, 2, 2) -> (2, 2, 1) redistribute that leaves ranks 4-7 idle
MOVES = (((2, 2, 2), 8, (2, 2, 2), 16), ((4, 2, 1), 8, (4, 2, 1), 4),
         ((2, 2, 2), 8, (4, 2, 1), 16), ((2, 2, 2), 8, (2, 2, 1), 8))
PROFILED_SHAPES = ((2, 2, 2), (2, 2, 1))
LU_SUBSTEPS = ("step0_reduce", "step1_pivot", "step23_rows", "step45_trsm",
               "step6_update")
CHOL_SUBSTEPS = ("step0_reduce", "step1_potrf", "step2_trsm_write",
                 "step3_bcast", "step4_update")


def _gen(seed, m, n=None):
    return np.random.default_rng(seed).standard_normal(
        (m, m if n is None else n)).astype(np.float32)


def _spd(seed, n):
    B = np.random.default_rng(seed).standard_normal((n, n))
    return (B @ B.T + n * np.eye(n)).astype(np.float32)


def _cfg():
    return {
        "pgemm": (_gen(1, N), _gen(2, N), V),
        "pgemm_shapes": PGEMM_SHAPES,
        "lu_gates": [(s, _gen(10 + i, m, n), V)
                     for i, (s, m, n) in enumerate(LU_GATES)],
        "chol_gates": [(s, _spd(20 + i, n), V)
                       for i, (s, n) in enumerate(CHOL_GATES)],
        "retile": (_gen(3, N), MOVES),
        "scalapack": (_gen(4, N), _spd(5, N), (2, 2, 2)),
        "profiled": (_gen(6, N), _spd(7, N), V),
        "profiled_shapes": PROFILED_SHAPES,
    }


@pytest.fixture(scope="module")
def world():
    return run_ranks(8, torch_ranks.dist_rest_cases, _cfg(), device="cpu",
                     timeout=300)


def _blocks_of(G, shape):
    """[P, Ml, Nl]: the blocks of a JAX (Pz, Px*Ml, Py*Nl) array in the
    port's rank order, rank = (pi*Py + pj)*Pz + pz."""
    Px, Py, Pz = shape
    G = np.asarray(G)
    Ml, Nl = G.shape[1] // Px, G.shape[2] // Py
    return np.stack([G[pz, pi * Ml:(pi + 1) * Ml, pj * Nl:(pj + 1) * Nl]
                     for pi in range(Px) for pj in range(Py)
                     for pz in range(Pz)])


def test_every_rank_is_jax_free(world):
    assert all(r["jax_free"] for r in world)


@pytest.mark.parametrize("shape", PGEMM_SHAPES,
                         ids=["x".join(map(str, s)) for s in PGEMM_SHAPES])
def test_pgemm_matches_numpy_and_jax(world, shape):
    A, B, _ = _cfg()["pgemm"]
    C = world[0][("pgemm", shape)]
    np.testing.assert_allclose(C, A @ B, rtol=1e-4, atol=1e-3)
    desc = JBlockCyclic.create(N, N, V, jmake_grid(shape))
    Cj = jpgemm(jdistribute(A, desc), jdistribute(B, desc), desc)
    np.testing.assert_allclose(C, np.asarray(jundistribute(Cj, desc)),
                               rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("i", range(len(LU_GATES)),
                         ids=[f"{'x'.join(map(str, s))}-{m}x{n}"
                              for s, m, n in LU_GATES])
def test_lu_residual_dist(world, i):
    shape, m, n = LU_GATES[i]
    got = [r[("lu_gate", i)] for r in world]
    res = got[0]["res"]
    assert all(g["res"] == res for g in got if g["res"] is not None)
    A = _cfg()["lu_gates"][i][1]
    desc = JBlockCyclic.create(m, n, V, jmake_grid(shape))
    Ap = np.asarray(jpad_like(A, desc))
    F, perm = got[0]["F"], got[0]["perm"]
    host = validation.lu_residual_dense(Ap, F, perm)
    # JAX's gate on the port's factor (its gathered F redistributed)
    Fp = np.asarray(jdistribute(F, desc))
    jres = float(jplu_residual_25d(jdistribute(A, desc), Fp, perm, desc,
                                   n_true=n, m_true=m))
    assert res <= GATE
    assert host / 3 < res < host * 3
    assert jres / 3 < res < jres * 3


@pytest.mark.parametrize("i", range(len(CHOL_GATES)),
                         ids=[f"{'x'.join(map(str, s))}-{n}"
                              for s, n in CHOL_GATES])
def test_cholesky_residual_dist(world, i):
    shape, n = CHOL_GATES[i]
    got = [r[("chol_gate", i)] for r in world]
    res = got[0]["res"]
    assert all(g["res"] == res for g in got if g["res"] is not None)
    S = _cfg()["chol_gates"][i][1]
    L = got[0]["L"]
    desc = JBlockCyclic.create(n, n, V, jmake_grid(shape))
    Sp = np.asarray(jpad_like(S, desc))
    host = validation.cholesky_residual_dense(Sp[:n, :n], L[:n, :n])
    jres = float(jpchol_residual_25d(jdistribute(S, desc),
                                     jdistribute(L, desc), desc, n_true=n))
    assert res <= GATE
    assert host / 3 < res < host * 3
    assert jres / 3 < res < jres * 3


@pytest.mark.parametrize("i", range(len(MOVES)),
                         ids=[f"{'x'.join(map(str, a))}v{b}-"
                              f"{'x'.join(map(str, c))}v{d}"
                              for a, b, c, d in MOVES])
def test_retile_matches_jax(world, i):
    s_shape, s_v, d_shape, d_v = MOVES[i]
    A = _cfg()["retile"][0]
    got = world[0][("retile", i)]
    Pd = int(np.prod(d_shape))
    blocks = got["blocks"]
    assert blocks.shape[0] == Pd
    if s_shape == d_shape:
        grid = jmake_grid(s_shape)
        src = JBlockCyclic.create(N, N, s_v, grid)
        dst = JBlockCyclic.create(N, N, d_v, grid)
        want = jretile(jdistribute(A, src), src, dst)
    else:
        # across grids JAX moves the array with device_put: the result is
        # the destination layout of the same matrix
        want = jdistribute(A, JBlockCyclic.create(N, N, d_v,
                                                  jmake_grid(d_shape)))
    np.testing.assert_array_equal(blocks, _blocks_of(want, d_shape))
    # and back again, on every rank of the source grid
    Ps = int(np.prod(s_shape))
    backs = [r[("retile", i)]["back_equal"] for r in world]
    assert all(backs[:Ps]) and all(b is None for b in backs[Ps:])


def test_retile_raises_on_different_global_shapes():
    grid = make_grid((1, 1, 1), device="cpu")
    src = BlockCyclic.create(64, 64, 8, grid)
    dst = BlockCyclic.create(72, 72, 8, grid)
    with pytest.raises(ConfluxError) as e:
        retile(None, src, dst)
    assert e.value.code == ErrorCode.LAYOUT_MISMATCH


def test_pdgetrf_matches_jax(world):
    A, _, shape = _cfg()["scalapack"]
    f = jpdgetrf(A, jmake_grid(shape))
    got = world[0]["pdgetrf"]
    assert got["v"] == f.desc.v
    np.testing.assert_array_equal(got["perm"], np.asarray(f.perm))
    np.testing.assert_array_equal(got["ipiv"], f.ipiv())
    Fj = f.dense()
    assert np.abs(got["F"] - Fj).max() / np.abs(Fj).max() <= F_TOL
    assert all(r["pdgetrf"]["F"] is None for r in world[1:])


def test_pdpotrf_matches_jax(world):
    _, S, shape = _cfg()["scalapack"]
    f = jpdpotrf(S, jmake_grid(shape))
    got = world[0]["pdpotrf"]
    assert got["v"] == f.desc.v
    Lj = f.dense()
    assert np.abs(got["L"] - Lj).max() / np.abs(Lj).max() <= F_TOL


@pytest.mark.parametrize("shape", PROFILED_SHAPES,
                         ids=["x".join(map(str, s)) for s in PROFILED_SHAPES])
def test_profiled_programs(world, shape):
    P = int(np.prod(shape))
    for r, rank in enumerate(world):
        got = rank[("profiled", shape)]
        if r >= P:      # idle: no regions entered, nothing returned
            assert got["same"] is None and not got["tables"]["lu"]
            continue
        # the same bits as lu_25d / cholesky_25d(unroll=False)
        assert got["same"] is True
        for path, names in (("lu", LU_SUBSTEPS),
                            ("cholesky", CHOL_SUBSTEPS)):
            table = got["tables"][path]
            assert sorted(table) == sorted(names)
            for name in names:
                calls, wall = table[name]
                assert calls == got["Nt"] and wall > 0, (path, name)
        assert all(name in got["report"] for name in CHOL_SUBSTEPS)


def test_profiler_report_matches_jax():
    # the same region tree prints the same PP() table in both packages
    tables = []
    for mod in (profiler, jprofiler):
        p = mod.Profiler()
        for name, wall in (("outer", 0.5), ("inner", 0.25), ("outer", 1.0)):
            p.enter(name)
            p.leave()
            node = p.root.children[name]
            node.wall = wall
        p.root.children["outer"].children["leaf"] = type(
            p.root.children["outer"])(calls=3, wall=0.125)
        tables.append(p.report())
    assert tables[0] == tables[1]
    assert "leaf" in tables[0] and "REGION" in tables[0]


# (N, v, Px, Pz, Py, rowpart, variant)
SIM_CASES = ((32, 4, 2, 2, 2, 0, "rightlook"), (32, 4, 2, 2, 2, 2, "crout"),
             (36, 4, 3, 1, 2, 1, "rightlook"), (32, 4, 1, 4, 2, 0, "crout"))


@pytest.mark.parametrize("case", SIM_CASES,
                         ids=["-".join(map(str, c)) for c in SIM_CASES])
def test_simulators_match_jax(case):
    n, v, Px, Pz, Py, rowpart, variant = case
    A = _gen(8, n).astype(np.float64)
    Ft, pt, ct = spec.tournament_lu_np(A, v, Px, Pz, Py, rowpart, variant)
    Fj, pj, cj = jspec.tournament_lu_np(A, v, Px, Pz, Py, rowpart, variant)
    np.testing.assert_array_equal(Ft, Fj)
    np.testing.assert_array_equal(pt, pj)
    assert vars(ct) == vars(cj)
    assert vars(spec.model_comm_volume(n, v, Px, Pz, Py, rowpart, variant)
                ) == vars(cj)
    for chol in ("rightlook", "crout"):
        assert (spec.model_cholesky_comm_volume(n, v, Px, Py, Pz, chol)
                == jspec.model_cholesky_comm_volume(n, v, Px, Py, Pz, chol))


def test_lazy_exports_and_launch_default():
    import inspect

    import conflux_tpu_torch
    from conflux_tpu_torch import launch, pgemm, scalapack

    assert (conflux_tpu_torch.pdgetrf, conflux_tpu_torch.pdpotrf) == (
        scalapack.pdgetrf, scalapack.pdpotrf)
    assert (conflux_tpu_torch.plu_residual_25d,
            conflux_tpu_torch.pchol_residual_25d) == (
        pgemm.plu_residual_25d, pgemm.pchol_residual_25d)
    # as in the JAX package, no lazy name shadows a submodule's
    assert conflux_tpu_torch.pgemm is pgemm
    assert (conflux_tpu_torch.lu_residual_dist,
            conflux_tpu_torch.cholesky_residual_dist) == (
        validation.lu_residual_dist, validation.cholesky_residual_dist)
    # the ranks run on the card unless the caller asks for the CPU
    params = inspect.signature(launch.run_ranks).parameters
    assert params["device"].default == "cuda"
