"""The port's grid selection, block-cyclic index maps and (un)distribution
(conflux_tpu_torch/grid.py, layout.py) and its dispatch rules
(dispatch.py, spec.py), held to the JAX package.

The selection functions, index maps, the dispatch rule and the comm model
are copies: each must give JAX's value on every input below. For the
layout, one gloo world per grid shape ((2, 2, 2) and (3, 2, 1)) runs on
the CPU (`launch.run_ranks`, tests/torch_ranks.py): each rank's block
from the port's `distribute` must equal JAX's shard
G[pz, pi*Ml:(pi+1)*Ml, pj*Nl:(pj+1)*Nl] bit for bit (square, padded and
tall inputs), and `undistribute` must give rank 0 the padded matrix back
bit for bit. On the (2, 2, 2) world a (2, 2, 1) grid leaves ranks 4-7
idle, with a warning, as JAX's `make_grid` warns about idle devices.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

import conflux_tpu.dispatch as jdispatch
import conflux_tpu.grid as jgrid
import conflux_tpu.layout as jlayout
import conflux_tpu.spec as jspec
import torch_ranks
from conflux_tpu_torch import dispatch, grid, layout, spec
from conflux_tpu_torch.errors import ConfluxError, ErrorCode
from conflux_tpu_torch.launch import run_ranks
from conflux_tpu_torch.ops.collect import panel_rows_for_columns

# (A's shape, v) per grid shape: square, identity-padded, tall
MATS = {(2, 2, 2): [((64, 64), 8), ((40, 40), 8), ((96, 64), 8)],
        (3, 2, 1): [((48, 48), 8), ((40, 40), 8), ((56, 32), 8)]}


def _mat(shape, i):
    (m, n), _ = MATS[shape][i]
    rng = np.random.default_rng(3000 + 10 * sum(shape) + i)
    return rng.standard_normal((m, n)).astype(np.float32)


@pytest.fixture(scope="module")
def port():
    worlds = {}

    def get(shape):
        if shape not in worlds:
            mats = [(_mat(shape, i), v) for i, (_, v) in
                    enumerate(MATS[shape])]
            worlds[shape] = run_ranks(int(np.prod(shape)),
                                      torch_ranks.layout_cases, shape, mats,
                                      device="cpu", timeout=300)
        return worlds[shape]

    return get


@pytest.mark.parametrize("M,N,P", [(4096, 4096, p) for p in
                                   (1, 2, 4, 8, 12, 16, 18, 32, 64)]
                         + [(8192, 2048, 8), (2048, 8192, 16), (96, 64, 6)])
def test_choose_grid_lu(M, N, P):
    assert grid.choose_grid_lu(M, N, P) == jgrid.choose_grid_lu(M, N, P)


@pytest.mark.parametrize("P,N", [(8, 8192), (8, 65536), (32, 4096),
                                 (128, 16384), (512, 65536), (16, 65536),
                                 (2, 1024), (64, 32768)])
def test_choose_grid_cholesky(P, N):
    assert grid.choose_grid_cholesky(P, N) == jgrid.choose_grid_cholesky(P, N)


@pytest.mark.parametrize("N,g,P", [(2048, (2, 2, 1), 4),
                                   (16384, (4, 4, 1), 16),
                                   (65536, (8, 8, 1), 64),
                                   (131072, (16, 16, 1), 256),
                                   (262144, (16, 16, 1), 256),
                                   (16384, (2, 2, 2), 8)])
def test_choose_tile_cholesky(N, g, P):
    assert (grid.choose_tile_cholesky(N, g, P)
            == jgrid.choose_tile_cholesky(N, g, P))


@pytest.mark.parametrize("P", [1, 2, 7, 8, 16, 27, 64, 100])
def test_choose_decomposition_and_parameters(P):
    assert grid.choose_decomposition(P) == jgrid.choose_decomposition(P)
    for n in (16, 1000, 16384):
        assert (grid.choose_parameters(n, P)
                == jgrid.choose_parameters(n, P))


def test_index_maps_match_jax():
    g = np.arange(256)
    for stride in (1, 3, 4):
        for a, b in zip(layout.g2l(g, stride), jlayout.g2l(g, stride)):
            np.testing.assert_array_equal(a, b)
        p, lt = layout.g2l(g, stride)
        np.testing.assert_array_equal(layout.l2g(p, lt, stride), g)
    for Px, v in ((4, 8), (3, 6)):
        for a, b in zip(layout.g2l_row(g, Px, v), jlayout.g2l_row(g, Px, v)):
            np.testing.assert_array_equal(a, b)
        for pi in range(Px):
            np.testing.assert_array_equal(
                layout.local_row_to_global(pi, Px, v, 4 * v).numpy(),
                np.asarray(jlayout.local_row_to_global(pi, Px, v, 4 * v)))
            np.testing.assert_array_equal(
                layout.local_tile_to_global(pi, Px, v, 4 * v).numpy(),
                np.asarray(jlayout.local_tile_to_global(pi, Px, v, 4 * v)))


@pytest.mark.parametrize("Px", [1, 2, 3, 4, 5, 6, 7, 8])
def test_butterfly_pair_matches_jax(Px):
    for r in range(max(1, (Px - 1).bit_length())):
        for pi in range(Px):
            assert (layout.butterfly_pair(pi, r, Px)
                    == jlayout.butterfly_pair(pi, r, Px))


@pytest.mark.parametrize("shape", list(MATS))
@pytest.mark.parametrize("i", range(3))
def test_distribute_matches_jax_shards(port, shape, i):
    ranks = port(shape)
    A = _mat(shape, i)
    v = MATS[shape][i][1]
    jdesc = jlayout.BlockCyclic.create(A.shape[0], A.shape[1], v,
                                       jgrid.make_grid(shape))
    G = np.asarray(jlayout.distribute(A, jdesc))
    Ml, Nl = jdesc.Ml, jdesc.Nl
    assert all(r["jax_free"] for r in ranks)
    for rank, r in enumerate(ranks):
        pi, pj, pz = r["coords"]
        assert rank == (pi * shape[1] + pj) * shape[2] + pz
        assert r["desc"][i] == (jdesc.M, jdesc.N, Ml, Nl, jdesc.nlayr)
        np.testing.assert_array_equal(
            r["blocks"][i],
            G[pz, pi * Ml:(pi + 1) * Ml, pj * Nl:(pj + 1) * Nl])
    # undistribute inverts it on rank 0, and only there
    np.testing.assert_array_equal(ranks[0]["back"][i],
                                  np.asarray(jlayout.pad_like(A, jdesc)))
    assert all(r["back"][i] is None for r in ranks[1:])


def test_smaller_grid_leaves_ranks_idle(port):
    ranks = port((2, 2, 2))
    assert all(r["idle_warned"] for r in ranks)
    assert [r["idle"] for r in ranks] == [False] * 4 + [True] * 4
    assert all(r["small_block"] is None for r in ranks[4:])
    A = _mat((2, 2, 2), 0)
    np.testing.assert_array_equal(ranks[0]["small_back"], A)
    assert all(r["small_back"] is None for r in ranks[1:])


@pytest.mark.parametrize("shape", [(48, 40), (40, 40), (64, 64), (56, 32)])
def test_pad_like_matches_jax(shape):
    g = SimpleNamespace(Px=2, Py=2, Pz=1)
    A = np.random.default_rng(5).standard_normal(shape).astype(np.float32)
    desc = layout.BlockCyclic.create(shape[0], shape[1], 8, g)
    jdesc = jlayout.BlockCyclic.create(shape[0], shape[1], 8, jgrid.make_grid(
        (2, 2, 1)))
    assert (desc.M, desc.N) == (jdesc.M, jdesc.N)
    want = np.asarray(jlayout.pad_like(A, jdesc))
    np.testing.assert_array_equal(layout.pad_like(A, desc), want)
    np.testing.assert_array_equal(
        layout.pad_like(torch.from_numpy(A), desc).numpy(), want)


def test_one_rank_grid_needs_no_process_group():
    g = grid.make_grid((1, 1, 1), device="cpu")
    assert (g.P, g.rank, g.pi, g.pj, g.pz) == (1, 0, 0, 0, 0)
    assert str(g) == "1x1x1" and g.device == torch.device("cpu")
    assert grid.make_grid(device="cpu").P == 1       # auto shape, world of 1


def test_grid_without_ranks_raises():
    with pytest.raises(ConfluxError) as e:
        grid.make_grid((2, 2, 2), device="cpu")
    assert e.value.code == ErrorCode.DEVICE_SHORTAGE


def _desc(N, Nt, shape=(1, 1, 1)):
    Px, Py, Pz = shape
    return SimpleNamespace(N=N, Nt=Nt, v=max(1, N // Nt), grid=SimpleNamespace(
        Px=Px, Py=Py, Pz=Pz, P=Px * Py * Pz))


@pytest.mark.parametrize("N,Nt,shape", [
    (131072, 512, (1, 1, 1)), (2048, 8, (1, 1, 1)), (4096, 8, (1, 1, 1)),
    (16384, 16, (1, 1, 1)), (16384, 16, (2, 2, 1)), (16384, 32, (2, 2, 2)),
    (16384, 16, (8, 8, 1)), (16384, 32, (1, 1, 1)), (262144, 512, (1, 1, 1)),
    (8192, 16, (3, 2, 1))])
@pytest.mark.parametrize("algorithm", ["lu", "cholesky"])
def test_choose_variant_matches_jax(N, Nt, shape, algorithm):
    d = _desc(N, Nt, shape)
    assert (dispatch.choose_variant(d, algorithm)
            == jdispatch.choose_variant(d, algorithm))
    if algorithm == "lu":
        assert (dispatch._lu_crout_grid_ok(d)
                == jdispatch._lu_crout_grid_ok(d))


def test_normalize_variant_and_segments_match_jax():
    d = _desc(64, 8)
    for unroll in (None, True, False, *dispatch.VARIANTS):
        assert (dispatch.normalize_variant(unroll, d, "lu")
                == jdispatch.normalize_variant(unroll, d, "lu"))
    with pytest.raises(ValueError):
        dispatch.normalize_variant("scan", d, "lu")
    for Nt in (1, 7, 8, 9, 64, 257):
        for w in (1, 3, 8):
            assert (dispatch.segment_bounds(Nt, w)
                    == jdispatch.segment_bounds(Nt, w))


@pytest.mark.parametrize("variant", ["rightlook", "crout"])
@pytest.mark.parametrize("rowpart", [0, 2])
@pytest.mark.parametrize("N,v,Px,Pz,Py", [(96, 8, 3, 2, 2),
                                          (16384, 512, 2, 2, 2),
                                          (65536, 1024, 8, 2, 8)])
def test_comm_model_matches_jax(N, v, Px, Pz, Py, rowpart, variant):
    got = spec.model_comm_volume(N, v, Px, Pz, Py, rowpart, variant)
    want = jspec.model_comm_volume(N, v, Px, Pz, Py, rowpart, variant)
    assert got == spec.CommVolume(**vars(want))


def test_panel_rows_for_columns_matches_jax():
    # one rank's view on a (2, 2, 1) grid: a stub stands in for the
    # all_gather over 'x' (it stacks both rows' panels); JAX runs its
    # function under shard_map on the two rows of a (2, 1, 1) mesh
    from conflux_tpu.ops.collect import panel_rows_for_columns as jprc

    v, w, mtl = 4, 3, 3
    Lb = [np.random.default_rng(pi).standard_normal((mtl * v, w)).astype(
        np.float32) for pi in range(2)]

    class Stub:
        def all_gather(self, t, axis):
            return torch.stack([torch.from_numpy(x) for x in Lb])

    mesh = jgrid.make_grid((2, 1, 1)).mesh
    for pj in range(2):
        for base in ((0, 0), (1, 1), (2, 1)):
            got = panel_rows_for_columns(Stub(), torch.from_numpy(Lb[0]), v,
                                         2, 2, pj, 2, *base).numpy()

            def body(x, pj=pj, base=base):
                return jprc(x[0], v, 2, 2, pj, 2, *base)[None]

            want = shard_map(body, mesh=mesh, in_specs=P("x"),
                             out_specs=P("x"))(np.stack(Lb))
            np.testing.assert_array_equal(got, np.asarray(want)[0])


def test_lazy_distributed_api():
    import conflux_tpu_torch
    from conflux_tpu_torch import launch
    from conflux_tpu_torch.cholesky import p25d as cp25d
    from conflux_tpu_torch.lu import p25d as lp25d

    assert conflux_tpu_torch.make_grid is grid.make_grid
    assert conflux_tpu_torch.run_ranks is launch.run_ranks
    assert (conflux_tpu_torch.lu_25d, conflux_tpu_torch.plu) == (
        lp25d.lu_25d, lp25d.plu)
    assert (conflux_tpu_torch.cholesky_25d, conflux_tpu_torch.pcholesky) == (
        cp25d.cholesky_25d, cp25d.pcholesky)
