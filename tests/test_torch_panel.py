"""Parity of the PyTorch port's panel factorization (conflux_tpu_torch/ops/
panel.py) with the JAX reference (conflux_tpu/ops/panel.py), and checks of
the rank-1 block kernel K1 (conflux_tpu_torch/ops/cuda_panel.py), of the
pivot-triangle solve's dispatch (conflux_tpu_torch/ops/cuda_trsm.py), and
of the panel loop's pivot-lane moves: bit for bit the one-hot products
they replace (tests/torch_onehot_panel.py), with one matrix product per
deferred update.

The plain rank-1 block is held to both the JAX twin and the Pallas kernel
run in interpret mode, as tests/test_panel.py runs it. Pivots must be
equal; values agree within 1e-5 * max|ref| (both sides are fp32 with the
same operation order up to the summation order of the matrix products).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_onehot_panel
from torch.utils._python_dispatch import TorchDispatchMode

import conflux_tpu.ops.panel as jpanel
import conflux_tpu_torch.ops.panel as tpanel
from conflux_tpu.ops.pallas_panel import rank1_block_pallas_t
from conflux_tpu_torch.ops import cuda_lanes, cuda_panel, cuda_trsm

TOL = 1e-5
MODES = ["unforced", "forced", "finish"]


def _close(got, ref, tol=TOL):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    err = np.abs(got - ref).max() / np.abs(ref).max()
    assert err <= tol, err


def _block(m, w, mode, seed, masked=True):
    """[w, m] transposed block and [1, m] availability, from a seed. Forced
    mode serves diagonally dominant tiles, so its leading lanes are made
    so; one lane past the forced ones is masked."""
    rng = np.random.default_rng(seed)
    Mt = rng.standard_normal((w, m)).astype(np.float32)
    if mode == "forced":
        Mt[np.arange(w), np.arange(w)] += w
    avail = np.ones((1, m), np.float32)
    if masked:
        avail[0, m - 3] = 0.0
    return Mt, avail


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("m,w", [(96, 16), (32, 8), (200, 128)])
def test_rank1_block_matches_jax_twin_and_pallas(m, w, mode):
    Mt, avail = _block(m, w, mode, seed=m + w)
    forced, finish = mode == "forced", mode == "finish"
    got = tpanel._rank1_block_t(torch.from_numpy(Mt), torch.from_numpy(avail),
                                0, forced, finish)
    twin = jpanel._rank1_block_t(jnp.asarray(Mt), jnp.asarray(avail), 0,
                                 forced, finish)
    kern = rank1_block_pallas_t(jnp.asarray(Mt), jnp.asarray(avail),
                                forced=forced, j0=0, interpret=True,
                                finish=finish)
    for ref in (twin, kern):
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))
        np.testing.assert_array_equal(got[3].numpy(), np.asarray(ref[3]) > 0)
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
        _close(got[0].numpy(), ref[0])


def test_rank1_block_leaves_inputs_unchanged(rng):
    Mt = torch.from_numpy(rng.standard_normal((8, 40)).astype(np.float32))
    avail = torch.ones(1, 40)
    Mt0, avail0 = Mt.clone(), avail.clone()
    tpanel._rank1_block_t(Mt, avail, 0, False)
    assert torch.equal(Mt, Mt0) and torch.equal(avail, avail0)


def _straight_rank1(Mt, avail, forced, j0=0):
    """K1's arithmetic in numpy: the straight right-looking elimination,
    one column at a time over all later rows (no micro-panels)."""
    Mt, avail = Mt.copy(), avail[0].copy()
    w, m = Mt.shape
    piv = np.zeros(w, np.int64)
    for jj in range(w):
        col = Mt[jj]
        if forced:
            p = j0 + jj
        else:
            p = int(np.argmax(np.where(avail > 0, np.abs(col), -np.inf)))
        piv[jj] = p
        safe = col[p] if col[p] != 0 else np.float32(1.0)
        elim = avail > 0
        elim[p] = False
        mult = np.where(elim, col / safe, np.float32(0.0)).astype(np.float32)
        Mt[jj + 1:] -= Mt[jj + 1:, p:p + 1] * mult[None, :]
        Mt[jj] = np.where(elim, mult, col)
        avail[p] = 0.0
    return Mt, piv


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("m,w", [(96, 40), (300, 128)])
def test_straight_elimination_matches_two_level(m, w, mode):
    # K1 replaces the two-level micro-panel structure by the straight
    # elimination: equal pivots, equal non-pivot lanes in every mode, and
    # in forced/finish mode equal pivot lanes too (the straight form
    # freezes a pivot lane once selected, holding its merged factor)
    Mt, avail = _block(m, w, mode, seed=7 * m + w)
    forced, finish = mode == "forced", mode == "finish"
    got, piv = _straight_rank1(Mt, avail, forced)
    ref = tpanel._rank1_block_t(torch.from_numpy(Mt), torch.from_numpy(avail),
                                0, forced, finish)
    np.testing.assert_array_equal(piv, ref[2].numpy())
    keep = np.ones(m, bool)
    if mode == "unforced":
        keep[piv] = False
    _close(got[:, keep], ref[0].numpy()[:, keep], tol=2e-5)


@pytest.mark.parametrize("merged", [True, False])
@pytest.mark.parametrize("m,w,block", [(200, 96, 32), (300, 160, 64)])
def test_factor_panel_raw_matches_jax(rng, m, w, block, merged):
    A = rng.standard_normal((m, w)).astype(np.float32)
    active = np.ones(m, bool)
    active[::37] = False
    piv, ok, M, lu = tpanel.factor_panel_raw(
        torch.from_numpy(A), torch.from_numpy(active), w, block=block,
        merged=merged)
    jpiv, jok, jM, jlu = jpanel.factor_panel_raw(
        jnp.asarray(A), jnp.asarray(active), w, block=block, merged=merged)
    np.testing.assert_array_equal(piv.numpy(), np.asarray(jpiv))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    _close(M.numpy(), jM)
    if merged:
        _close(lu.numpy(), jlu)
    else:
        assert lu is None and jlu is None


def test_factor_panel_raw_across_groups_matches_jax(rng):
    # w = 640 crosses the _GROUP = 512 boundary: the outer grouped update
    # and its finishing write, at the main path's block=128 and
    # merged=False. The 640-long elimination chain amplifies the fp32
    # summation-order differences of the two packages' products by the
    # panel's pivot growth, so values are held to 1e-4 here (measured
    # 4e-5); pivots must still be equal
    m, w = 700, 640
    A = rng.standard_normal((m, w)).astype(np.float32)
    piv, ok, M, _ = tpanel.factor_panel_raw(
        torch.from_numpy(A), torch.ones(m, dtype=torch.bool), w, block=128,
        merged=False)
    jpiv, _, jM, _ = jpanel.factor_panel_raw(
        jnp.asarray(A), jnp.ones(m, bool), w, block=128, merged=False)
    np.testing.assert_array_equal(piv.numpy(), np.asarray(jpiv))
    assert bool(ok.all())
    _close(M.numpy(), jM, tol=1e-4)
    # the finished pivot rows are the merged factor: P A == L U on them
    merged = M.numpy()[piv.numpy()]
    L = np.tril(merged, -1) + np.eye(w, dtype=np.float32)
    np.testing.assert_allclose(A[piv.numpy()], L @ np.triu(merged),
                               rtol=0, atol=5e-4)


@pytest.mark.parametrize("m,w", [(24, 8), (300, 140)])
def test_select_pivots_and_factor_panel_match_jax(rng, m, w):
    A = rng.standard_normal((m, w)).astype(np.float32)
    active = np.ones(m, bool)
    active[3] = False
    piv, ok, lu = tpanel.select_pivots(torch.from_numpy(A),
                                       torch.from_numpy(active), w)
    jpiv, jok, jlu = jpanel.select_pivots(jnp.asarray(A), jnp.asarray(active),
                                          w)
    np.testing.assert_array_equal(piv.numpy(), np.asarray(jpiv))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    _close(lu.numpy(), jlu)
    piv2, _, M = tpanel.factor_panel(torch.from_numpy(A),
                                     torch.from_numpy(active), w)
    _, _, jM = jpanel.factor_panel(jnp.asarray(A), jnp.asarray(active), w)
    np.testing.assert_array_equal(piv2.numpy(), np.asarray(jpiv))
    _close(M.numpy(), jM)


def test_select_pivots_flags_insufficient_rows(rng):
    A = rng.standard_normal((6, 4)).astype(np.float32)
    active = torch.zeros(6, dtype=torch.bool)
    active[:2] = True
    _, ok, _ = tpanel.select_pivots(torch.from_numpy(A), active, 4)
    assert ok[:2].all() and not ok[2:].any()


@pytest.mark.parametrize("n", [8, 200])
def test_lu_nopivot_matches_jax(rng, n):
    A = (rng.standard_normal((n, n)) + n * np.eye(n)).astype(np.float32)
    got = tpanel.lu_nopivot(torch.from_numpy(A)).numpy()
    _close(got, jpanel.lu_nopivot(jnp.asarray(A)))
    L = np.tril(got, -1) + np.eye(n, dtype=np.float32)
    res = np.linalg.norm(A - L @ np.triu(got)) / np.linalg.norm(A)
    assert res < 1e-5, res


def test_dispatch_takes_plain_version_on_cpu_only(rng):
    Bt = torch.from_numpy(rng.standard_normal((8, 40)).astype(np.float32))
    avail = torch.ones(1, 40)
    out = tpanel._rank1_dispatch(Bt, avail, 0, False)
    ref = tpanel._rank1_block_t(Bt, avail, 0, False)
    assert torch.equal(out[0], ref[0]) and torch.equal(out[2], ref[2])
    with pytest.raises(ValueError, match="no rank-1 block kernel"):
        tpanel._rank1_dispatch(Bt.to("meta"), avail.to("meta"), 0, False)


def test_kernel_wrapper_refuses_cpu_tensors():
    before = cuda_panel.LAUNCHES
    with pytest.raises(ValueError, match="CUDA"):
        cuda_panel.rank1_block_t(torch.zeros(4, 16), torch.ones(1, 16))
    assert cuda_panel.LAUNCHES == before


# the pivot-triangle solve of the panel's updates: n the block widths (32,
# Cholesky's 64, a ragged 96, crout's 128) and the group width 512; r the
# rows solved for (one, and up to the rows past a 1536-wide panel's first
# group)
SOLVE_N = [32, 64, 96, 128, 512]
SOLVE_R = [1, 128, 384, 1024]


@functools.lru_cache(maxsize=None)
def _pivot_triangle(n, dtype):
    """lu [n, n], column-major as the panel forms it: the merged factors of
    the n pivot rows that partial pivoting selects from a random [2n, n]
    block (its L's entries within 1), with kappa_inf(L) from float64."""
    rng = np.random.default_rng(n)
    block = torch.from_numpy(rng.standard_normal((2 * n, n))).to(dtype)
    _, _, lu = tpanel.select_pivots(block, torch.ones(2 * n, dtype=torch.bool),
                                    n, block=128)
    L = torch.tril(lu.double(), -1) + torch.eye(n, dtype=torch.float64)
    kappa = float(L.abs().sum(1).max() * torch.linalg.inv(L).abs().sum(1).max())
    return lu.T.contiguous().T, kappa


@pytest.mark.parametrize("group", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("r", SOLVE_R)
@pytest.mark.parametrize("n", SOLVE_N)
def test_pivot_solve_plain_matches_solve_triangular(n, r, dtype, group):
    lu, kappa = _pivot_triangle(n, dtype)
    B = torch.from_numpy(
        np.random.default_rng(n + r).standard_normal((r, n))).to(dtype)
    X = tpanel._pivot_solve_t(B, lu, group)
    assert torch.equal(X, tpanel._pivot_solve_plain(B, lu, group))
    L = torch.tril(lu.double(), -1) + torch.eye(n, dtype=torch.float64)
    ref = torch.linalg.solve_triangular(L.T, B.double(), upper=True,
                                        left=False)
    # a triangular solve's forward error is of the order of eps kappa(L)
    # max|B|; both plain forms stay under a tenth of it here
    tol = torch.finfo(dtype).eps * kappa * float(B.abs().max())
    assert float((X.double() - ref).abs().max()) <= tol


def test_pivot_solve_on_cpu_never_loads_the_kernel(rng, monkeypatch):
    # a panel past one group: inner and outer updates both solve
    from conflux_tpu_torch.ops import _build

    def refuse(name):
        raise AssertionError(f"{name} was loaded for CPU tensors")

    monkeypatch.setattr(_build, "load", refuse)
    before = cuda_trsm.LAUNCHES
    panel = torch.from_numpy(rng.standard_normal((600, 530)).astype(np.float32))
    _, ok, _ = tpanel._lu_select_loop_t(
        panel, torch.ones(600, dtype=torch.bool), 530, forced=False,
        finish=True)
    assert bool(ok.all()) and cuda_trsm.LAUNCHES == before
    with pytest.raises(ValueError, match="no pivot-triangle solve"):
        tpanel._pivot_solve_t(torch.zeros(4, 8, device="meta"),
                              torch.zeros(8, 8, device="meta"), False)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_trsm.solve_unit_lower_t(torch.zeros(4, 8), torch.eye(8))
    assert cuda_trsm.LAUNCHES == before


# the panel loop's pivot-lane moves: m lanes, npiv > _GROUP columns in
# 128-wide blocks, so 3 inner deferred updates and one outer one. 'fewer'
# leaves 200 rows active (lane 0 among them): blocks 128..255 are partly
# and 256..639 wholly not ok, and their pivots repeat lane 0 (the plain
# K1's argmax over no available lane), an ok pivot's lane
LOOP_M, LOOP_NPIV, LOOP_BLOCK = 700, 640, 128


def _loop_panel(mode, dtype, rows, seed=5):
    """[m, npiv] panel and [m] active rows; forced mode gets a diagonally
    dominant leading square (it eliminates in order)."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((LOOP_M, LOOP_NPIV))
    if mode == "forced":
        A[np.arange(LOOP_NPIV), np.arange(LOOP_NPIV)] += LOOP_NPIV
    active = np.ones(LOOP_M, bool)
    if rows == "fewer":
        active[:] = False
        active[0] = True
        active[1 + rng.permutation(LOOP_M - 1)[:199]] = True
    return torch.from_numpy(A).to(dtype), torch.from_numpy(active)


@pytest.mark.parametrize("rows", ["all", "fewer"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("mode", MODES)
def test_select_loop_equals_onehot_formulation(mode, dtype, rows):
    # the pivot lanes moved by index give the one-hot products' values
    # exactly (a -0 aside, which torch.equal takes for +0): the same piv,
    # ok and Pt, bit for bit, through inner and outer updates, with and
    # without the finishing scatter
    panel, active = _loop_panel(mode, dtype, rows)
    forced, finish = mode == "forced", mode == "finish"
    got = tpanel._lu_select_loop_t(panel, active, LOOP_NPIV, forced,
                                   block=LOOP_BLOCK, finish=finish)
    ref = torch_onehot_panel.onehot_select_loop_t(
        panel, active, LOOP_NPIV, forced, block=LOOP_BLOCK, finish=finish)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    piv, ok, _ = got
    if rows == "all":
        assert bool(ok.all())
    elif not forced:
        # not-ok entries exist past block 128 and name an ok pivot's lane
        assert int(ok.sum()) == 200 and bool(ok[:200].all())
        assert set(piv[~ok].tolist()) & set(piv[ok].tolist())


class _Products(TorchDispatchMode):
    """Records the operand shapes of every matrix product dispatched while
    not paused."""

    PRODUCTS = {torch.ops.aten.mm, torch.ops.aten.addmm, torch.ops.aten.bmm,
                torch.ops.aten.baddbmm, torch.ops.aten.mv, torch.ops.aten.dot}

    def __init__(self):
        super().__init__()
        self.shapes = []
        self.paused = False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not self.paused and func.overloadpacket in self.PRODUCTS:
            self.shapes.append(tuple(tuple(a.shape) for a in args
                                     if isinstance(a, torch.Tensor)))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("mode", MODES)
def test_select_loop_issues_one_product_per_update(mode, monkeypatch):
    # outside K1 and the pivot-triangle solve (each one kernel on the
    # card), a deferred update issues one matrix product, the multipliers'
    # U12t [rest, w] @ Lmul_t [w, m], and no product with an m-wide one-hot
    # operand; its pivot lanes move by one gather, and by one scatter where
    # the elimination finishes its pivot lanes (forced pivots are sliced)
    panel, active = _loop_panel(mode, torch.float32, "all")
    forced, finish = mode == "forced", mode == "finish"
    rec = _Products()

    def paused(fn):
        def call(*args, **kwargs):
            rec.paused = True
            try:
                return fn(*args, **kwargs)
            finally:
                rec.paused = False
        return call

    monkeypatch.setattr(tpanel, "_rank1_dispatch",
                        paused(tpanel._rank1_dispatch))
    monkeypatch.setattr(tpanel, "_pivot_solve_t",
                        paused(tpanel._pivot_solve_t))
    before = tpanel.LANE_MOVES
    with rec:
        tpanel._lu_select_loop_t(panel, active, LOOP_NPIV, forced,
                                 block=LOOP_BLOCK, finish=finish)
    moves = tpanel.LANE_MOVES - before
    m, npiv, block = LOOP_M, LOOP_NPIV, LOOP_BLOCK
    want = [((512 - b1, block), (block, m))
            for b1 in range(block, 512, block)]
    want.append(((npiv - 512, 512), (512, m)))
    assert torch_onehot_panel.updates_of(npiv, block) == (3, 1)
    assert sorted(rec.shapes) == sorted(want)
    per_update = {"unforced": 1, "finish": 2, "forced": 0}[mode]
    assert moves == per_update * len(want)


def test_lane_moves_plain_versions(rng):
    # entries not ok read 0 and write nothing, whatever lane they name
    src = torch.from_numpy(rng.standard_normal((5, 30)))
    piv = torch.tensor([7, 3, 7, 0, 29])
    ok = torch.tensor([True, True, False, False, True])
    got = tpanel._gather_lanes(src, piv, ok)
    want = src[:, piv].clone()
    want[:, ~ok] = 0
    assert got.is_contiguous() and torch.equal(got, want)
    dst = src.clone()
    vals = torch.from_numpy(rng.standard_normal((5, 5)))
    tpanel._scatter_lanes(dst, piv, ok, vals)
    want = src.clone()
    want[:, [7, 3, 29]] = vals[:, [0, 1, 4]]
    assert torch.equal(dst, want)


def test_lane_moves_take_plain_versions_on_cpu_only(monkeypatch):
    from conflux_tpu_torch.ops import _build

    def refuse(name):
        raise AssertionError(f"{name} was loaded for CPU tensors")

    monkeypatch.setattr(_build, "load", refuse)
    before = (cuda_lanes.GATHER_LAUNCHES, cuda_lanes.SCATTER_LAUNCHES)
    piv, ok = torch.tensor([1, 0]), torch.tensor([True, True])
    tpanel._gather_lanes(torch.ones(3, 4), piv, ok)
    tpanel._scatter_lanes(torch.ones(3, 4), piv, ok, torch.zeros(3, 2))
    meta = torch.zeros(3, 4, device="meta")
    with pytest.raises(ValueError, match="no pivot-lane gather"):
        tpanel._gather_lanes(meta, piv.to("meta"), ok.to("meta"))
    with pytest.raises(ValueError, match="no pivot-lane scatter"):
        tpanel._scatter_lanes(meta, piv.to("meta"), ok.to("meta"),
                              torch.zeros(3, 2, device="meta"))
    with pytest.raises(ValueError, match="CUDA"):
        cuda_lanes.gather_lanes(torch.ones(3, 4), piv, ok)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_lanes.scatter_lanes_(torch.ones(3, 4), piv, ok,
                                  torch.zeros(3, 2))
    assert (cuda_lanes.GATHER_LAUNCHES,
            cuda_lanes.SCATTER_LAUNCHES) == before
