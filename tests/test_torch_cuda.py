"""Tests of the PyTorch port that need a CUDA card: the hand-written kernels
K1 (conflux_tpu_torch/csrc/rank1_panel.cu), K3 (csrc/schur_update.cu), K2
and K4 (csrc/bigk_gemm.cu), K5 and K6 (csrc/row_move.cu) against their
plain PyTorch versions, the split pass of K3 and K2 against
ops/tri._split_hi_lo bit for bit, the routes of K1, K2, K3, K4 and K5/K6
by their launch counters, the crout LU (all three compactions), the flat
LU and the Cholesky end to end on the card, and the entry points' results
bit-identical whatever TF32 setting the caller chose, K1 in double
(csrc/rank1_panel_f64.cu) on each of its routes, the panel's
pivot-triangle solve (csrc/panel_trsm.cu) against its plain version and
by its launches per factorization, crout's winners' solve with its
diagonal kernel (csrc/lower_solve.cu) against its plain version at the
cells' shapes and by its launches per factorization, the panel's
pivot-lane gather and scatter (csrc/lane_move.cu) against their plain
versions and the panel loop bit for bit against its one-hot formulation
(tests/torch_onehot_panel.py), and one float64 crout factorization at
the benchmark cell lu.f64.n32768's size: its launches per kernel, its
phase spans and its reading by the cell's judge. Without a card every
test here skips.

This file imports no jax, so it also runs where jax is not installed:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import numpy as np
import pytest
import torch
import torch_onehot_panel

from conflux_tpu_torch import profiler
from conflux_tpu_torch.cholesky.single import cholesky
from conflux_tpu_torch.lu.single import lu_factor
from conflux_tpu_torch.ops import cuda_gemm, cuda_lanes, \
    cuda_lower_solve, cuda_panel, cuda_scatter, cuda_trsm, gemm, tri
from conflux_tpu_torch.ops.gemm import (
    _matmul_t,
    _schur_update_t,
    _sub_matmul_bigk_t,
)
from conflux_tpu_torch.ops.panel import (
    _gather_lanes,
    _lu_select_loop_t,
    _pivot_solve_plain,
    _pivot_solve_t,
    _rank1_block_t,
    _scatter_lanes,
    select_pivots,
)
from conflux_tpu_torch.precision import ieee_fp32
from conflux_tpu_torch.ops.scatter import _gather_rows_t, _scatter_rows_t
from conflux_tpu_torch.ops.tri import _split_hi_lo
from conflux_tpu_torch.solve import cho_solve, lu_solve
from conflux_tpu_torch.validation import (
    cholesky_residual_blocked,
    lu_residual_blocked,
)

pytestmark = pytest.mark.cuda

MODES = ["unforced", "forced", "finish"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (K1 has no CPU mode)")
    return torch.device("cuda")


def _block(m, w, mode, seed, j0=0):
    """[w, m] transposed block and [1, m] availability from a seed. With
    j0 = 0 one lane is masked; with j0 > 0 the lanes below j0 are (the
    earlier blocks' pivots). Forced mode gets diagonally dominant lanes
    j0..j0+w-1."""
    rng = np.random.default_rng(seed)
    Mt = rng.standard_normal((w, m)).astype(np.float32)
    if mode == "forced":
        Mt[np.arange(w), j0 + np.arange(w)] += w
    avail = np.ones((1, m), np.float32)
    if j0:
        avail[0, :j0] = 0.0
    else:
        avail[0, m - 3] = 0.0
    return Mt, avail


# (w, m, mode, j0): [128, m] blocks in every mode, and forced blocks at the
# tile shapes of flat's _pivot_factors ([128, 1536]) and Cholesky's
# potrf_tile ([64, 1536]) with their first pivot at j0 > 0
K1_CASES = ([(128, m, mode, 0) for m in (1000, 32768) for mode in MODES]
            + [(128, 1536, "forced", 1408), (64, 1536, "forced", 64),
               (64, 1536, "forced", 1472)])


@pytest.mark.parametrize("w,m,mode,j0", K1_CASES)
def test_kernel_matches_plain_on_card(card, w, m, mode, j0):
    Mt, avail = _block(m, w, mode, seed=m + j0, j0=j0)
    Mt = torch.from_numpy(Mt).to(card)
    avail = torch.from_numpy(avail).to(card)
    forced, finish = mode == "forced", mode == "finish"
    _k1_check(Mt, avail, mode, j0)


def _k1_counts():
    return (cuda_panel.LAUNCHES, cuda_panel.LAUNCHES_CLUSTER,
            cuda_panel.LAUNCHES_GRID, cuda_panel.LAUNCHES_TILE,
            cuda_panel.LAUNCHES_GRID_CLUSTERED)


def _k1_check(Mt, avail, mode, j0, masked_read=True):
    """One K1 call against its plain version: the route its counters show
    (forced blocks up to w = 128 on the tile route; others on the cluster
    route up to cluster_max_m(w) lanes, the grid route past it, counted
    as clustered where grid_cluster(w, m) names a cluster size), pivots,
    ok and avail equal, the block within a few fp32 roundings
    (NaN where the plain version has NaN). masked_read=False leaves the
    lanes masked on input out of the comparison: callers never read them,
    and the plain version's one-hot products carry a NaN into them (NaN
    times 0) where the kernel leaves them untouched."""
    w, m = Mt.shape
    forced, finish = mode == "forced", mode == "finish"
    ref = _rank1_block_t(Mt, avail, j0, forced, finish)
    before = _k1_counts()
    got = cuda_panel.rank1_block_t(Mt, avail, forced, j0, finish)
    torch.cuda.synchronize()
    route = cuda_panel.route(w, m, forced)
    assert route == ("tile" if forced and w <= 128 else
                     "cluster" if m <= cuda_panel.cluster_max_m(w) else
                     "grid")
    clustered = route == "grid" and cuda_panel.grid_cluster(w, m) > 0
    assert tuple(a - b for a, b in zip(_k1_counts(), before)) == (
        1, int(route == "cluster"), int(route == "grid"),
        int(route == "tile"), int(clustered))
    assert torch.equal(ref[2], got[2].long())
    assert torch.equal(ref[3], got[3] > 0)
    assert torch.equal(ref[1], got[1])
    keep = torch.ones(m, dtype=torch.bool, device=Mt.device)
    if mode == "unforced":
        keep[ref[2]] = False      # stale in the plain version, unread
    if not masked_read:
        keep &= avail[0] > 0
    r, g = ref[0][:, keep], got[0][:, keep]
    assert torch.equal(torch.isnan(r), torch.isnan(g))
    fin = ~torch.isnan(r)
    if bool(fin.any()):
        # K1 applies the updates in another order than the two-level plain
        # version: agreement to a few fp32 roundings
        diff = (r[fin] - g[fin]).abs().max()
        assert diff <= 1e-4 * r[fin].abs().max()


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("w", [128, 64])
@pytest.mark.parametrize("past", [0, 128])
def test_k1_routes_at_their_boundary(card, w, mode, past):
    # the largest block the cluster route takes, and 128 lanes more on the
    # grid route; a masked lane, and forced blocks with j0 > 0
    m = cuda_panel.cluster_max_m(w) + past
    j0 = 3 * w if mode == "forced" else 0
    Mt, avail = _block(m, w, mode, seed=m + w, j0=j0)
    if j0 == 0:
        avail[0, 17] = 0.0
    _k1_check(torch.from_numpy(Mt).to(card), torch.from_numpy(avail).to(card),
              mode, j0)


@pytest.mark.parametrize("past", [0, 128])
def test_k1_forced_wide_blocks_take_cluster_and_grid(card, past):
    # forced blocks wider than the tile route takes (w = 160) run on the
    # cluster route up to its widest block and on the grid route past it
    w = 160
    m = cuda_panel.cluster_max_m(w) + past
    Mt, avail = _block(m, w, "forced", seed=m, j0=w)
    _k1_check(torch.from_numpy(Mt).to(card), torch.from_numpy(avail).to(card),
              "forced", w)


@pytest.mark.parametrize("m", [1536, 40000])
def test_k1_nan_ranks_highest_on_both_routes(card, m):
    # a NaN in the first column of an available lane: both versions pick
    # it as the first pivot, its multipliers are NaN, and every later
    # column's scores are NaN, so the pivots go to the lowest available
    # lanes in order
    w = 128
    Mt, avail = _block(m, w, "unforced", seed=m)
    Mt[0, 777] = np.nan
    _k1_check(torch.from_numpy(Mt).to(card), torch.from_numpy(avail).to(card),
              "unforced", 0, masked_read=False)


# K1's grid route in clusters (w, m, mode, j0, case): the narrowest grid
# blocks (1 and 128 lanes past the cluster route's widest), the LU cells'
# and the miniapp's widths (33792 lanes: 132 CTAs' worth), the distributed
# panels' [64, 8192] and the recursive scheme's [64, 32768], a forced
# block too wide for the tile route (w = 256), the earlier blocks' pivots
# masked (j0 > 0), and columns with ties, a NaN, and no available lane
K1_GRID_CASES = [
    (128, "edge+1", "finish", 0, "plain"),
    (128, "edge+128", "unforced", 0, "plain"),
    (128, 4096, "unforced", 0, "plain"),
    (128, 16384, "finish", 0, "plain"),
    (128, 32768, "finish", 0, "plain"),
    (128, 33792, "finish", 0, "plain"),
    (64, 8192, "unforced", 0, "plain"),
    (64, 32768, "unforced", 0, "plain"),
    (256, 4096, "forced", 256, "plain"),
    (128, 16384, "finish", 1536, "plain"),
    (128, 32768, "unforced", 0, "ties"),
    (128, 32768, "unforced", 0, "nan"),
    (128, 16384, "finish", 0, "few lanes"),
]


@pytest.mark.parametrize("w,m,mode,j0,case", K1_GRID_CASES)
def test_k1_grid_route_in_clusters(card, w, m, mode, j0, case):
    # every such block takes the grid route in clusters of 8 on an H100
    # and matches the plain version as _k1_check holds it
    if isinstance(m, str):
        m = cuda_panel.cluster_max_m(w) + int(m.split("+")[1])
    assert cuda_panel.route(w, m, mode == "forced") == "grid"
    assert cuda_panel.grid_cluster(w, m) == 8
    Mt, avail = _block(m, w, mode, seed=m + w + j0, j0=j0)
    masked_read = True
    if case == "ties":
        # column 0's largest |x| in four lanes of different clusters, one
        # of them negative, and column 5's in two lanes that hold the same
        # column (so the same updates): the lowest lane wins
        for lane in (29000, 700, 15000):
            Mt[0, lane] = 50.0
        Mt[0, 100] = -50.0
        Mt[:, 31000] = Mt[:, 9000]
        Mt[5, [9000, 31000]] = 60.0
    elif case == "nan":
        # in column 0, so the plain version's deferred products carry it
        # into the same lanes as the kernel's updates
        Mt[0, 20000] = np.nan
        masked_read = False
    elif case == "few lanes":
        # five available lanes for 128 columns: from column 5 on no lane is
        # available, so the pivot is lane 0 with ok = 0
        avail[:] = 0.0
        avail[0, [10, 3000, 9000, 12000, 16000]] = 1.0
        masked_read = False
    _k1_check(torch.from_numpy(Mt).to(card), torch.from_numpy(avail).to(card),
              mode, j0, masked_read=masked_read)


def test_k1_grid_route_repeats_bit_for_bit(card):
    # calls one after another on the kept scratch take fresh tags each
    # time: the same block gives the same bits, after a call of another
    # width in between too
    Mt, avail = _block(32768, 128, "finish", seed=5)
    Mt = torch.from_numpy(Mt).to(card)
    avail = torch.from_numpy(avail).to(card)
    first = cuda_panel.rank1_block_t(Mt, avail, False, 0, True)
    other = torch.from_numpy(_block(8192, 64, "unforced", seed=6)[0]).to(card)
    cuda_panel.rank1_block_t(other, torch.ones(1, 8192, device=card))
    for _ in range(3):
        again = cuda_panel.rank1_block_t(Mt, avail, False, 0, True)
        assert all(torch.equal(a, b) for a, b in zip(first, again))


def test_kernel_wrapper_checks_its_inputs(card):
    Mt = torch.zeros(8, 64, device=card)
    avail = torch.ones(1, 64, device=card)
    with pytest.raises(TypeError):
        cuda_panel.rank1_block_t(Mt.double(), avail.double())
    with pytest.raises(ValueError, match="contiguous"):
        cuda_panel.rank1_block_t(torch.zeros(64, 8, device=card).T, avail)
    with pytest.raises(ValueError, match="forced pivots"):
        cuda_panel.rank1_block_t(Mt, avail, forced=True, j0=60)
    with pytest.raises(ValueError):
        cuda_panel.rank1_block_t(torch.zeros(2, 65537, device=card),
                                 torch.ones(1, 65537, device=card))


@pytest.mark.parametrize("precision", ["high", "highest"])
def test_crout_on_card_meets_gate(card, precision):
    # the main path at a small size: every panel block goes through K1, and
    # in 'high' every big-K product through K2 (the panel update of each
    # step with k > 0, the pivot-row refresh of each with k + w < n too)
    n, v = 1024, 256
    g = torch.Generator(device=card).manual_seed(3)
    A = torch.randn(n, n, generator=g, device=card)
    before = (cuda_panel.LAUNCHES, cuda_gemm.SUB_MATMUL_BIGK_WGMMA_LAUNCHES)
    F, perm = lu_factor(A, v=v, precision=precision, scheme="crout")
    assert cuda_panel.LAUNCHES - before[0] == (n // v) * (v // 128)
    assert cuda_gemm.SUB_MATMUL_BIGK_WGMMA_LAUNCHES - before[1] == (
        2 * (n // v) - 3 if precision == "high" else 0)
    assert F.is_cuda and bool(torch.isfinite(F).all())
    assert torch.equal(torch.sort(perm).values, torch.arange(n, device=card))
    assert lu_residual_blocked(A, F, perm) <= 1e-6


@pytest.mark.parametrize("precision", ["high", "highest"])
def test_recursive_on_card_runs_k1_alone(card, precision):
    # every leaf selects its pivots in 64-wide K1 blocks and refactors its
    # pivot rows in forced ones; the Schur products are library calls, so
    # K2 and K3 never run; 'auto' below the threshold is this scheme
    from conflux_tpu_torch.lu.single import auto_scheme

    n, v = 1024, 256
    g = torch.Generator(device=card).manual_seed(8)
    A = torch.randn(n, n, generator=g, device=card)
    before = (cuda_panel.LAUNCHES, cuda_gemm.SUB_MATMUL_BIGK_LAUNCHES,
              cuda_gemm.SCHUR_UPDATE_LAUNCHES)
    F, perm = lu_factor(A, v=v, precision=precision, scheme="recursive")
    assert cuda_panel.LAUNCHES - before[0] == 2 * (n // v) * (v // 64)
    assert (cuda_gemm.SUB_MATMUL_BIGK_LAUNCHES,
            cuda_gemm.SCHUR_UPDATE_LAUNCHES) == before[1:]
    assert lu_residual_blocked(A, F, perm) <= 1e-6
    assert auto_scheme(n) == "recursive"
    Fa, pa = lu_factor(A, v=v, precision=precision)
    assert torch.equal(pa, perm) and torch.equal(Fa, F)


def _bf16_ulp(x):
    _, e = torch.frexp(x.float())
    ulp = torch.ldexp(torch.ones_like(x, dtype=torch.float32), e - 8)
    return torch.where(x == 0, 2.0 ** -133, ulp)


@pytest.mark.parametrize("mode", ["high", "bf16", "bf16out"])
@pytest.mark.parametrize("m,ncols,k,c0,c1", [(2048, 2048, 512, 512, 2048),
                                             (1000, 1040, 200, 37, 1000)])
def test_k3_matches_plain_on_card(card, m, ncols, k, c0, c1, mode):
    # a tile-aligned span and a ragged one (odd c0, columns past c1); the
    # two take the same bf16 operand values and differ in fp32 summation
    # order only, so max|diff| <= 1e-5 * max(|A| @ |B|), plus one bf16 ulp
    # of the result where R is bf16
    g = torch.Generator(device=card).manual_seed(m + k)
    A = torch.randn(m, k, generator=g, device=card)
    B = torch.randn(k, c1 - c0, generator=g, device=card)
    R = torch.randn(m, ncols, generator=g, device=card)
    if mode == "bf16out":
        R = R.to(torch.bfloat16)
    _k3_check(R, A, B, c0, c1, mode)


def _k3_check(R, A, B, c0, c1, mode):
    """One K3 call on a copy of R against the plain version: the wgmma
    route by its counter, columns outside [c0, c1) unchanged, the span
    within the fp32 summation tolerance (plus one bf16 ulp where R is
    bf16)."""
    ref = _schur_update_t(R.clone(), A, B, c0, mode, c1)
    before = (cuda_gemm.SCHUR_UPDATE_LAUNCHES,
              cuda_gemm.SCHUR_UPDATE_WGMMA_LAUNCHES)
    got = R.clone()
    assert cuda_gemm.schur_update(got, A, B, c0, mode, c1) is got
    torch.cuda.synchronize()
    assert (cuda_gemm.SCHUR_UPDATE_LAUNCHES,
            cuda_gemm.SCHUR_UPDATE_WGMMA_LAUNCHES) == (before[0] + 1,
                                                       before[1] + 1)
    assert torch.equal(got[:, :c0], R[:, :c0])
    assert torch.equal(got[:, c1:], R[:, c1:])
    tol = 1e-5 * float(torch.mm(A.abs(), B.abs()).max())
    d = (got[:, c0:c1].float() - ref[:, c0:c1].float()).abs()
    if mode == "bf16out":
        assert bool((d <= _bf16_ulp(ref[:, c0:c1]) + tol).all())
    else:
        assert float(d.max()) <= tol


@pytest.mark.parametrize("mode", ["high", "bf16", "bf16out"])
@pytest.mark.parametrize("m,ncols,k,c0,c1", [(777, 1100, 333, 64, 1000),
                                             (130, 600, 70, 8, 300),
                                             (4100, 520, 1536, 0, 517)])
def test_k3_ragged_and_strided_on_card(card, m, ncols, k, c0, c1, mode):
    # ragged m, k and c1 off the [128, 256] tile and the K chunk of 64,
    # with TMA-aligned span starts (the TMA-store epilogue); R a strided
    # view into a wider buffer, and A and B column slices of wider ones
    g = torch.Generator(device=card).manual_seed(m + c1)
    R = torch.randn(m, ncols + 24, generator=g, device=card)[:, 16:16 + ncols]
    A = torch.randn(m, k + 5, generator=g, device=card)[:, 5:]
    B = torch.randn(k, c1 - c0 + 3, generator=g, device=card)[:, :c1 - c0]
    if mode == "bf16out":
        R = R.to(torch.bfloat16)
    _k3_check(R, A, B, c0, c1, mode)


@pytest.mark.parametrize("offset", [3, 4])
def test_k3_split_pass_is_bit_identical(card, offset):
    # ops/tri._split_hi_lo on the same tensor, bit for bit: normal values,
    # bf16 rounding ties, subnormals, signed zeros, infinities and NaN, in
    # a strided view whose rows start off 16 bytes (element copies) or on
    # them (16-byte loads)
    g = torch.Generator(device=card).manual_seed(31)
    x = torch.randn(300, 211, generator=g, device=card) * 1e3
    x[0, :8] = torch.tensor([0.0, -0.0, float("inf"), -float("inf"),
                             float("nan"), 1e-40, -3e-39, 1.17e-38])
    # exact ties between two bf16 values, and just off them
    ties = torch.tensor([1.0 + 2.0 ** -8, 1.0 + 3 * 2.0 ** -8,
                         -(1.0 + 2.0 ** -8), 1.0 + 2.0 ** -8 + 2.0 ** -20],
                        device=card)
    x[1, :4] = ties
    x[2] = torch.ldexp(torch.rand(211, generator=g, device=card),
                       torch.full((211,), -140.0, device=card))
    view = x[:, offset:200]
    hi, lo = cuda_gemm.split_hi_lo(view)
    torch.cuda.synchronize()
    rh, rl = _split_hi_lo(view)
    assert torch.equal(hi.view(torch.int16), rh.view(torch.int16))
    assert torch.equal(lo.view(torch.int16), rl.view(torch.int16))


def test_k3_wrapper_checks_its_inputs(card):
    R = torch.zeros(64, 64, device=card)
    A = torch.zeros(64, 16, device=card)
    B = torch.zeros(16, 32, device=card)
    with pytest.raises(TypeError):
        cuda_gemm.schur_update(R, A, B, 32, "bf16out")
    with pytest.raises(TypeError):
        cuda_gemm.schur_update(R, A.double(), B, 32, "high")
    with pytest.raises(ValueError, match="span"):
        cuda_gemm.schur_update(R, A, B, 48, "high")
    with pytest.raises(ValueError, match="unit column stride"):
        cuda_gemm.schur_update(R, torch.zeros(16, 64, device=card).T, B, 32,
                               "high")
    with pytest.raises(ValueError):
        cuda_gemm.schur_update(R, A, B, 32, "highest")
    before = cuda_gemm.SCHUR_UPDATE_LAUNCHES
    cuda_gemm.schur_update(R, A[:, :0], B[:0], 32, "high")   # k = 0
    assert cuda_gemm.SCHUR_UPDATE_LAUNCHES == before


@pytest.mark.parametrize("precision", ["high", "bf16", "highest"])
def test_flat_on_card_meets_gate(card, precision):
    # every trailing update of 'high'/'bf16' goes through K3, one per step
    # with k + w < n; every panel runs K1 unforced and then forced
    n, v = 1024, 256
    g = torch.Generator(device=card).manual_seed(4)
    A = torch.randn(n, n, generator=g, device=card)
    k1, k3 = cuda_panel.LAUNCHES, cuda_gemm.SCHUR_UPDATE_LAUNCHES
    F, perm = lu_factor(A, v=v, precision=precision, scheme="flat")
    torch.cuda.synchronize()
    steps = n // v
    assert cuda_panel.LAUNCHES - k1 == 2 * steps * (v // 128)
    assert cuda_gemm.SCHUR_UPDATE_LAUNCHES - k3 == (
        0 if precision == "highest" else steps - 1)
    assert bool(torch.isfinite(F).all())
    assert torch.equal(torch.sort(perm).values, torch.arange(n, device=card))
    # one bf16 pass per update does not reach the 1e-6 gate: the plain
    # version's same arithmetic gives 6.7e-5 on this input on the CPU
    gate = 2e-4 if precision == "bf16" else 1e-6
    assert lu_residual_blocked(A, F, perm) <= gate


def test_cholesky_on_card_meets_gate(card):
    # every tile through K1 forced; every panel update with k > 0 through
    # K2, its B a transposed view
    n, v = 1024, 256
    g = torch.Generator(device=card).manual_seed(5)
    X = torch.rand(n, n, generator=g, device=card)
    A = (X + X.T) / 2 + n * torch.eye(n, device=card)
    before = (cuda_panel.LAUNCHES, cuda_gemm.SUB_MATMUL_BIGK_WGMMA_LAUNCHES)
    L = cholesky(A, v=v, precision="high")
    torch.cuda.synchronize()
    assert cuda_panel.LAUNCHES - before[0] == (n // v) * (v // 64)
    assert cuda_gemm.SUB_MATMUL_BIGK_WGMMA_LAUNCHES - before[1] == n // v - 1
    assert torch.equal(L, torch.tril(L))
    assert cholesky_residual_blocked(A, L) <= 1e-6


# K2 (m, n, k): a tile-aligned call with enough tiles to run unsplit, a
# ragged one with a long K that the kernel splits across units, a 37-wide
# output (not 16-byte rows: stores from registers), the crout refresh at
# k = 30720 (its most heavily split call: [1536, 512], 22 splits on 132
# SMs), and a 300-wide output whose bf16 rows (600 bytes) break TMA's
# rules; R and A are strided column slices
K2_CASES = [(2048, 2048, 512), (300, 200, 4096), (1000, 37, 1500),
            (1536, 512, 30720), (1000, 300, 200)]


@pytest.mark.parametrize("mode", ["high", "bf16", "bf16out"])
@pytest.mark.parametrize("m,n,k", K2_CASES)
def test_k2_matches_plain_on_card(card, m, n, k, mode):
    # the same bf16 operand values as the plain version: fp32 summation
    # order only, max|diff| <= 1e-5 * max(|A| @ |B|) (plus one bf16 ulp of
    # the result where R is bf16)
    g = torch.Generator(device=card).manual_seed(m + n + k)
    big = torch.randn(m, n + k + 3, generator=g, device=card)
    R, A = big[:, :n], big[:, n + 3:]
    B = torch.randn(k, n, generator=g, device=card)
    if mode == "bf16out":
        R = R.to(torch.bfloat16)
    R0 = R.clone()
    ref = _sub_matmul_bigk_t(R, A, B, mode)
    before = (cuda_gemm.SUB_MATMUL_BIGK_LAUNCHES,
              cuda_gemm.SUB_MATMUL_BIGK_WGMMA_LAUNCHES)
    got = cuda_gemm.sub_matmul_bigk(R, A, B, mode)
    torch.cuda.synchronize()
    assert (cuda_gemm.SUB_MATMUL_BIGK_LAUNCHES,
            cuda_gemm.SUB_MATMUL_BIGK_WGMMA_LAUNCHES) == (before[0] + 1,
                                                          before[1] + 1)
    assert torch.equal(R, R0) and got.dtype == R.dtype
    tol = 1e-5 * float(torch.mm(A.abs(), B.abs()).max())
    d = (got.float() - ref.float()).abs()
    if mode == "bf16out":
        assert bool((d <= _bf16_ulp(ref) + tol).all())
    else:
        assert float(d.max()) <= tol
    # the same call twice gives the same bits (split-K sums in fixed order)
    assert torch.equal(got, cuda_gemm.sub_matmul_bigk(R, A, B, mode))


def _k2_plan_splits(m, n, k, sms):
    """K2's rule: [128, 256] tiles, K chunks of 64; split only below four
    waves of tiles, at least 16 chunks a split, no split left empty."""
    tiles = -(-m // 128) * -(-n // 256)
    chunks = -(-k // 64)
    splits = 1
    if tiles < 4 * sms:
        splits = max(1, min(-(-4 * sms // tiles), chunks // 16))
    per = -(-chunks // splits)
    return -(-chunks // per)


@pytest.mark.parametrize("mode", ["high", "bf16", "bf16out"])
@pytest.mark.parametrize("m,n,k", [(1000, 300, 700), (640, 256, 2500)])
def test_k2_reads_a_transposed_b_on_card(card, m, n, k, mode):
    # Cholesky's B is the view F[k:k+w, :k].T (unit row stride): the split
    # pass reads it in place, ragged 32 x 32 tiles included; the second
    # shape splits K
    g = torch.Generator(device=card).manual_seed(m + k)
    A = torch.randn(m, k, generator=g, device=card)
    B = torch.randn(n, k + 40, generator=g, device=card)[:, 7:7 + k].T
    R = torch.randn(m, n, generator=g, device=card)
    if mode == "bf16out":
        R = R.to(torch.bfloat16)
    assert B.stride(0) == 1
    ref = _sub_matmul_bigk_t(R, A, B, mode)
    got = cuda_gemm.sub_matmul_bigk(R, A, B, mode)
    torch.cuda.synchronize()
    tol = 1e-5 * float(torch.mm(A.abs(), B.abs()).max())
    d = (got.float() - ref.float()).abs()
    if mode == "bf16out":
        assert bool((d <= _bf16_ulp(ref) + tol).all())
    else:
        assert float(d.max()) <= tol
    # the same values through a row-major B give the same bits
    assert torch.equal(got, cuda_gemm.sub_matmul_bigk(R, A, B.contiguous(),
                                                      mode))


def test_k2_splits_k_only_short_of_tiles(card):
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    shapes = [(2048, 2048, 512), (300, 200, 4096), (31232, 1536, 1536),
              (17408, 1536, 15360), (2048, 1536, 30720), (1536, 512, 30720),
              (1536, 15872, 15360)]
    for m, n, k in shapes:
        assert cuda_gemm.sub_matmul_bigk_splits(m, n, k) == _k2_plan_splits(
            m, n, k, sms)
    assert cuda_gemm.sub_matmul_bigk_splits(2048, 2048, 512) == 1
    assert cuda_gemm.sub_matmul_bigk_splits(300, 200, 4096) > 1
    assert cuda_gemm.sub_matmul_bigk_splits(31232, 1536, 1536) == 1
    if sms == 132:
        # the crout path's late panel update and refresh
        assert cuda_gemm.sub_matmul_bigk_splits(2048, 1536, 30720) == 6
        assert cuda_gemm.sub_matmul_bigk_splits(1536, 512, 30720) == 22


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,n,k", [(512, 384, 640), (130, 70, 333)])
def test_k4_matches_plain_on_card(card, m, n, k, dtype):
    # f32: IEEE fp32 FMAs against cuBLAS's fp32; bf16: exact products,
    # fp32 sums; either way the summation order only
    g = torch.Generator(device=card).manual_seed(m * n + k)
    a = torch.randn(m, k, generator=g, device=card).to(dtype)
    b = torch.randn(k, n, generator=g, device=card).to(dtype)
    before = cuda_gemm.MATMUL_LAUNCHES
    got = cuda_gemm.matmul(a, b)
    torch.cuda.synchronize()
    assert cuda_gemm.MATMUL_LAUNCHES == before + 1
    assert got.dtype == torch.float32 and got.shape == (m, n)
    ref = _matmul_t(a, b)
    tol = 1e-5 * float(torch.mm(a.float().abs(), b.float().abs()).max())
    assert float((got - ref).abs().max()) <= tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,n,w", [(4096, 2048, 256), (777, 333, 50)])
def test_k5_k6_match_plain_on_card_bit_for_bit(card, m, n, w, dtype):
    g = torch.Generator(device=card).manual_seed(m + w)
    base = torch.randn(m, n + 5, generator=g, device=card).to(dtype)
    R = base[:, 5:]                        # a strided view for the gather
    idx = torch.randperm(m, generator=g, device=card)[:w]
    b6 = cuda_scatter.GATHER_ROWS_LAUNCHES
    got = cuda_scatter.gather_rows(R, idx)
    assert torch.equal(got, _gather_rows_t(R, idx))
    assert cuda_scatter.GATHER_ROWS_LAUNCHES == b6 + 1
    Rs = base.clone()
    src = torch.randn(w, n + 5, generator=g, device=card).to(dtype)
    want = _scatter_rows_t(Rs.clone(), src, idx)
    b5 = cuda_scatter.SCATTER_ROWS_LAUNCHES
    assert cuda_scatter.scatter_rows(Rs, src, idx) is Rs
    torch.cuda.synchronize()
    assert cuda_scatter.SCATTER_ROWS_LAUNCHES == b5 + 1
    assert torch.equal(Rs, want)


@pytest.mark.parametrize("precision", ["high", "highest"])
@pytest.mark.parametrize("compaction", ["split", "swap"])
def test_crout_compactions_on_card_meet_gate(card, compaction, precision):
    # split and swap run their big-K products through K2 ('high'), their
    # row gathers through K6 and swap's push-up through K5
    n, v = 1024, 256
    steps = n // v
    g = torch.Generator(device=card).manual_seed(6)
    A = torch.randn(n, n, generator=g, device=card)
    A0 = A.clone()
    before = (cuda_panel.LAUNCHES, cuda_gemm.SUB_MATMUL_BIGK_LAUNCHES,
              cuda_scatter.SCATTER_ROWS_LAUNCHES,
              cuda_scatter.GATHER_ROWS_LAUNCHES)
    F, perm = lu_factor(A, v=v, precision=precision, scheme="crout",
                        compaction=compaction)
    torch.cuda.synchronize()
    k1, k2, k5, k6 = (a - b for a, b in zip(
        (cuda_panel.LAUNCHES, cuda_gemm.SUB_MATMUL_BIGK_LAUNCHES,
         cuda_scatter.SCATTER_ROWS_LAUNCHES,
         cuda_scatter.GATHER_ROWS_LAUNCHES), before))
    assert k1 == 2 * steps * (v // 128)
    assert k2 == (0 if precision == "highest" else 2 * steps - 3)
    if compaction == "swap":
        assert (k5, k6) == (steps - 1, 2 * steps + steps - 1)
    else:
        assert (k5, k6) == (0, 2 * steps + 4 * (steps - 1) - 1)
    assert torch.equal(A, A0)
    assert torch.equal(torch.sort(perm).values, torch.arange(n, device=card))
    assert lu_residual_blocked(A, F, perm) <= 1e-6


def _k4_counts():
    return (cuda_gemm.MATMUL_LAUNCHES, cuda_gemm.MATMUL_WGMMA_LAUNCHES,
            cuda_gemm.MATMUL_MMA_SYNC_LAUNCHES)


def _k4_check(a, b, route):
    """One K4 call on a and b: the route it must take ('f32', 'wgmma' or
    'mma.sync') by the route counters, the result within the fp32
    summation tolerance of the plain version, and the same bits from a
    second call."""
    before = _k4_counts()
    got = cuda_gemm.matmul(a, b)
    torch.cuda.synchronize()
    step = {"f32": (1, 0, 0), "wgmma": (1, 1, 0), "mma.sync": (1, 0, 1)}
    assert tuple(x - y for x, y in zip(_k4_counts(), before)) == step[route]
    assert got.dtype == torch.float32
    assert got.shape == (a.shape[0], b.shape[1])
    ref = _matmul_t(a, b)
    tol = 1e-5 * float(torch.mm(a.float().abs(), b.float().abs()).max())
    assert float((got - ref).abs().max()) <= tol
    assert torch.equal(got, cuda_gemm.matmul(a, b))


# (m, n, k) with 16-byte-aligned contiguous operands: edges off the
# wgmma kernel's [128, 256] tile and its K chunk of 64, K below one chunk,
# a single 8-column box, and exactly one tile
K4_ALIGNED = [(200, 264, 136), (64, 8, 16), (300, 40, 24), (128, 256, 64),
              (1000, 520, 1000)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,n,k", K4_ALIGNED)
def test_k4_aligned_shapes_take_their_route(card, m, n, k, dtype):
    g = torch.Generator(device=card).manual_seed(m + 7 * n + 13 * k)
    a = torch.randn(m, k, generator=g, device=card).to(dtype)
    b = torch.randn(k, n, generator=g, device=card).to(dtype)
    _k4_check(a, b, "wgmma" if dtype == torch.bfloat16 else "f32")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k4_strided_views_take_their_route(card, dtype):
    # column slices of wider buffers: row strides 520 and 272 (multiples
    # of 8), offsets of 8 and 16 elements (16-byte aligned in bf16)
    g = torch.Generator(device=card).manual_seed(21)
    a = torch.randn(300, 520, generator=g, device=card).to(dtype)[:, 8:208]
    b = torch.randn(200, 272, generator=g, device=card).to(dtype)[:, 16:266]
    _k4_check(a, b, "wgmma" if dtype == torch.bfloat16 else "f32")


@pytest.mark.parametrize("case", ["odd stride", "offset base"])
def test_k4_unaligned_bf16_takes_mma_sync(card, case):
    # TMA needs a 16-byte-aligned base and a row stride that is a multiple
    # of 8 bf16: a contiguous [130, 333] A breaks the stride rule, a view
    # one element into its buffer the base rule
    g = torch.Generator(device=card).manual_seed(22)
    bf = torch.bfloat16
    if case == "odd stride":
        a = torch.randn(130, 333, generator=g, device=card).to(bf)
        b = torch.randn(333, 70, generator=g, device=card).to(bf)
    else:
        a = torch.randn(130, 264, generator=g, device=card).to(bf)[:, 1:]
        b = torch.randn(263, 72, generator=g, device=card).to(bf)
    _k4_check(a, b, "mma.sync")


def _k6_counts():
    return (cuda_scatter.GATHER_ROWS_LAUNCHES,
            cuda_scatter.GATHER_ROWS_BULK_LAUNCHES)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("width", [1536, 8, 13])
def test_k6_narrow_column_slices_on_card(card, width, dtype):
    # the split path's panel gather T[idx, k:k+w] at a small N: rows of
    # `width` columns with row stride 4096; 16-byte-multiple widths take
    # the bulk copies, 13 columns (52 or 26 bytes) the word copies
    g = torch.Generator(device=card).manual_seed(width)
    T = torch.randn(4096, 4096, generator=g, device=card).to(dtype)
    view = T[:, 1536:1536 + width]
    idx = torch.randperm(4096, generator=g, device=card)[:3000]
    before = _k6_counts()
    got = cuda_scatter.gather_rows(view, idx)
    torch.cuda.synchronize()
    bulk = width * T.element_size() % 16 == 0
    assert tuple(x - y for x, y in zip(_k6_counts(), before)) == (1, bulk)
    assert torch.equal(got, _gather_rows_t(view, idx))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("width", [512, 13])
def test_k5_k6_skip_indices_outside_rows(card, width, dtype):
    # an index outside [0, m) moves nothing and faults nothing, on both
    # routes: the gather leaves its output row unwritten, the scatter
    # leaves R as it was
    m = 1000
    g = torch.Generator(device=card).manual_seed(23 + width)
    R = torch.randn(m, width, generator=g, device=card).to(dtype)
    idx = torch.randperm(m, generator=g, device=card)[:64]
    idx[5], idx[40] = -1, m
    keep = torch.ones(64, dtype=torch.bool, device=card)
    keep[5] = keep[40] = False
    out = cuda_scatter.gather_rows(R, idx)
    torch.cuda.synchronize()
    assert torch.equal(out[keep], R[idx[keep]])
    out.fill_(7.0)
    assert cuda_scatter._move(False, R, out, idx, m) == (
        width * R.element_size() % 16 == 0)
    torch.cuda.synchronize()
    assert bool((out[~keep] == 7.0).all())
    src = torch.randn(64, width, generator=g, device=card).to(dtype)
    want = R.clone()
    want[idx[keep]] = src[keep]
    before = (cuda_scatter.SCATTER_ROWS_LAUNCHES,
              cuda_scatter.SCATTER_ROWS_BULK_LAUNCHES)
    assert cuda_scatter.scatter_rows(R, src, idx) is R
    torch.cuda.synchronize()
    assert cuda_scatter.SCATTER_ROWS_LAUNCHES == before[0] + 1
    assert cuda_scatter.SCATTER_ROWS_BULK_LAUNCHES == before[1] + (
        width * R.element_size() % 16 == 0)
    assert torch.equal(R, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k5_push_up_rows_on_card(card, dtype):
    # swap's push-up at a small N: whole rows of an [N, N] R, scattered to
    # unique slots, bit for bit, on the bulk route
    g = torch.Generator(device=card).manual_seed(24)
    R = torch.randn(2048, 2048, generator=g, device=card).to(dtype)
    src = torch.randn(256, 2048, generator=g, device=card).to(dtype)
    slots = torch.randperm(2048, generator=g, device=card)[:256]
    want = _scatter_rows_t(R.clone(), src, slots)
    before = cuda_scatter.SCATTER_ROWS_BULK_LAUNCHES
    assert cuda_scatter.scatter_rows(R, src, slots) is R
    torch.cuda.synchronize()
    assert cuda_scatter.SCATTER_ROWS_BULK_LAUNCHES == before + 1
    assert torch.equal(R, want)


def _knobs():
    return (torch.backends.cuda.matmul.fp32_precision,
            torch.backends.mkldnn.matmul.fp32_precision)


def _entry_results(A, S, b):
    """crout, flat and Cholesky at 'highest', both solves and the blocked
    residuals, on the card."""
    out = []
    for scheme in ("crout", "flat"):
        F, perm = lu_factor(A, v=256, scheme=scheme)
        out += [F, perm, torch.tensor(lu_residual_blocked(A, F, perm))]
    out.append(lu_solve(F, perm, b))
    L = cholesky(S, v=256)
    out += [L, torch.tensor(cholesky_residual_blocked(S, L)),
            cho_solve(L, b)]
    torch.cuda.synchronize()
    return out


def test_run_ranks_puts_each_rank_on_its_card(card):
    # run_ranks' default device is the card: each rank's bare "cuda"
    # tensors land on the card make_grid places the rank on
    import torch_ranks
    from conflux_tpu_torch.launch import run_ranks

    for r in run_ranks(2, torch_ranks.rank_devices, timeout=300):
        want = f"cuda:{r['rank'] % r['count']}"
        assert r["bare"] == r["grid"] == want


@pytest.mark.parametrize("api", ["legacy", "new"])
def test_tf32_on_leaves_results_bit_identical(card, api):
    # the caller turns TF32 on; the entry points pin IEEE fp32 for their
    # own products and give the caller's settings back
    n = 1024
    g = torch.Generator(device=card).manual_seed(8)
    A = torch.randn(n, n, generator=g, device=card)
    X = torch.rand(n, n, generator=g, device=card)
    S = (X + X.T) / 2 + n * torch.eye(n, device=card)
    b = torch.randn(n, generator=g, device=card)
    saved = _knobs()
    ref = _entry_results(A, S, b)
    try:
        if api == "legacy":
            torch.backends.cuda.matmul.allow_tf32 = True
            torch.set_float32_matmul_precision("high")
        else:
            torch.backends.cuda.matmul.fp32_precision = "tf32"
        before = _knobs()
        got = _entry_results(A, S, b)
        assert _knobs() == before
        if api == "legacy":
            assert torch.backends.cuda.matmul.allow_tf32 is True
            assert torch.get_float32_matmul_precision() == "high"
    finally:
        if api == "legacy":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.set_float32_matmul_precision("highest")
        for knob, value in zip((torch.backends.cuda.matmul,
                                torch.backends.mkldnn.matmul), saved):
            knob.fp32_precision = value
    assert all(torch.equal(r, g) for r, g in zip(ref, got))


# K1 in double (csrc/rank1_panel_f64.cu): the shapes of the route classes
# (tile-sized forced blocks, cluster-sized blocks, a grid-sized one, and
# one wider than its on-chip slab) in each mode
K1_F64_CASES = ([(128, m, mode, 0) for m in (1000, 2048, 32768)
                 for mode in MODES]
                + [(128, 1536, "forced", 1408), (64, 1536, "forced", 64),
                   (64, 40000, "unforced", 0)])


@pytest.mark.parametrize("w,m,mode,j0", K1_F64_CASES)
def test_k1_f64_matches_plain_on_card(card, w, m, mode, j0):
    Mt, avail = _block(m, w, mode, seed=m + j0 + 7, j0=j0)
    Mt = torch.from_numpy(Mt).to(card, torch.float64)
    avail = torch.from_numpy(avail).to(card, torch.float64)
    forced, finish = mode == "forced", mode == "finish"
    ref = _rank1_block_t(Mt, avail, j0, forced, finish)
    before = (cuda_panel.LAUNCHES, cuda_panel.LAUNCHES_F64)
    got = cuda_panel.rank1_block_t_f64(Mt, avail, forced, j0, finish)
    torch.cuda.synchronize()
    # its own counter moves, the float32 kernel's does not
    assert (cuda_panel.LAUNCHES, cuda_panel.LAUNCHES_F64) == (
        before[0], before[1] + 1)
    assert got[0].dtype == torch.float64 and got[1].dtype == torch.float64
    assert torch.equal(ref[2], got[2].long())
    assert torch.equal(ref[3], got[3] > 0)
    assert torch.equal(ref[1], got[1])
    keep = torch.ones(m, dtype=torch.bool, device=card)
    if mode == "unforced":
        keep[ref[2]] = False      # stale in the plain version, unread
    # the updates in another order than the two-level plain version: a few
    # f64 roundings
    diff = (ref[0][:, keep] - got[0][:, keep]).abs().max()
    assert diff <= 1e-12 * ref[0][:, keep].abs().max()


def _k1_f64_counts():
    return (cuda_panel.LAUNCHES, cuda_panel.LAUNCHES_F64,
            cuda_panel.LAUNCHES_F64_CLUSTER, cuda_panel.LAUNCHES_F64_GRID,
            cuda_panel.LAUNCHES_F64_TILE)


def _k1_f64_check(Mt, avail, mode, j0, route, masked_read=True):
    """One call of K1 in double against the plain version in float64: the
    route route_f64 names and its counter (forced blocks up to w = 128 on
    the tile route, others on the cluster route up to cluster_max_m_f64(w)
    lanes, the grid route past it), pivots, ok and avail equal, the block
    within 1e-12 of max|ref| (a few f64 roundings: the updates run in
    another order than the two-level plain version), NaN where the plain
    version has NaN; masked_read as in _k1_check."""
    w, m = Mt.shape
    forced, finish = mode == "forced", mode == "finish"
    assert cuda_panel.route_f64(w, m, forced) == route
    assert route == ("tile" if forced and w <= 128 else
                     "cluster" if m <= cuda_panel.cluster_max_m_f64(w) else
                     "grid")
    ref = _rank1_block_t(Mt, avail, j0, forced, finish)
    before = _k1_f64_counts()
    got = cuda_panel.rank1_block_t_f64(Mt, avail, forced, j0, finish)
    torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip(_k1_f64_counts(), before)) == (
        0, 1, int(route == "cluster"), int(route == "grid"),
        int(route == "tile"))
    assert torch.equal(ref[2], got[2].long())
    assert torch.equal(ref[3], got[3] > 0)
    assert torch.equal(ref[1], got[1])
    keep = torch.ones(m, dtype=torch.bool, device=Mt.device)
    if mode == "unforced":
        keep[ref[2]] = False      # stale in the plain version, unread
    if not masked_read:
        keep &= avail[0] > 0
    r, g = ref[0][:, keep], got[0][:, keep]
    assert torch.equal(torch.isnan(r), torch.isnan(g))
    fin = ~torch.isnan(r)
    if bool(fin.any()):
        assert (r[fin] - g[fin]).abs().max() <= 1e-12 * r[fin].abs().max()


# K1 in double per route, (w, m, mode, j0, route): the f64 crout's blocks
# (the grid route with its last rows in registers at [128, 32768], all of
# its slab in shared memory at [128, 17408], the global slab past 256
# lanes a CTA at [128, 40000]; the cluster route at [128, 2048]), the
# distributed f64 runs' [64, .] blocks, the forced tiles of the LU schemes
# and of the f64 Cholesky (tile route), and forced blocks wider than the
# tile route takes (cluster and grid)
K1_F64_ROUTE_CASES = [
    (128, 32768, "finish", 0, "grid"), (128, 32768, "unforced", 0, "grid"),
    (128, 17408, "unforced", 0, "grid"), (128, 17408, "finish", 0, "grid"),
    (128, 40000, "unforced", 0, "grid"), (64, 8192, "unforced", 0, "grid"),
    (128, 2048, "unforced", 0, "cluster"), (128, 2048, "finish", 0, "cluster"),
    (64, 1024, "unforced", 0, "cluster"), (128, 1000, "unforced", 0, "cluster"),
    (128, 1536, "forced", 128, "tile"), (128, 1536, "forced", 1408, "tile"),
    (64, 1536, "forced", 64, "tile"), (64, 1536, "forced", 1472, "tile"),
    (64, 512, "forced", 64, "tile"), (160, 1536, "forced", 160, "cluster"),
    (160, 3000, "forced", 160, "grid")]


@pytest.mark.parametrize("w,m,mode,j0,route", K1_F64_ROUTE_CASES)
def test_k1_f64_routes_match_plain_on_card(card, w, m, mode, j0, route):
    Mt, avail = _block(m, w, mode, seed=m + j0 + 11, j0=j0)
    _k1_f64_check(torch.from_numpy(Mt).to(card, torch.float64),
                  torch.from_numpy(avail).to(card, torch.float64),
                  mode, j0, route)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("w", [128, 64])
@pytest.mark.parametrize("past", [0, 128])
def test_k1_f64_routes_at_their_boundary(card, w, mode, past):
    # the largest block the double cluster route takes, and 128 lanes more
    # on its grid route; forced blocks on the tile route with j0 > 0
    m = cuda_panel.cluster_max_m_f64(w) + past
    j0 = 3 * w if mode == "forced" else 0
    Mt, avail = _block(m, w, mode, seed=m + w + 13, j0=j0)
    if j0 == 0:
        avail[0, 17] = 0.0
    route = ("tile" if mode == "forced" else
             "cluster" if past == 0 else "grid")
    _k1_f64_check(torch.from_numpy(Mt).to(card, torch.float64),
                  torch.from_numpy(avail).to(card, torch.float64),
                  mode, j0, route)


@pytest.mark.parametrize("m,route", [(1536, "cluster"), (17408, "grid"),
                                     (40000, "grid")])
def test_k1_f64_nan_ranks_highest(card, m, route):
    # as test_k1_nan_ranks_highest_on_both_routes, in double
    w = 128
    Mt, avail = _block(m, w, "unforced", seed=m)
    Mt[0, 777] = np.nan
    _k1_f64_check(torch.from_numpy(Mt).to(card, torch.float64),
                  torch.from_numpy(avail).to(card, torch.float64),
                  "unforced", 0, route, masked_read=False)


def test_k1_f64_dispatch_never_reaches_the_plain_version(card, monkeypatch):
    # a float64 panel on the card runs K1 in double only
    from conflux_tpu_torch.ops import panel

    def refuse(*args, **kwargs):
        raise AssertionError("the plain K1 ran on a CUDA block")

    monkeypatch.setattr(panel, "_rank1_block_t", refuse)
    g = torch.Generator(device=card).manual_seed(5)
    A = torch.randn(600, 200, generator=g, device=card, dtype=torch.float64)
    before = cuda_panel.LAUNCHES_F64
    piv, ok, M = panel.factor_panel(A, torch.ones(600, dtype=torch.bool,
                                                  device=card), 200)
    assert cuda_panel.LAUNCHES_F64 > before and bool(ok.all())
    assert M.dtype == torch.float64


# K2's bf16-operand entry: (m, n, k) at a crout panel update, split-K
# shapes (the bf16 crout's last panel update; a ragged one), a ragged
# shape, an A TMA cannot read in place (an odd offset, copied first),
# transposed B views read in place, K-major (a small one and the bf16
# Cholesky's first panel update, B = F[k:k+w, :k].T), and a transposed B
# whose row stride TMA cannot take (copied first, then read row-major)
K2_BF16_CASES = [(2048, 1536, 1536, "plain"), (1536, 512, 30720, "plain"),
                 (1000, 300, 200, "plain"), (777, 300, 500, "odd"),
                 (640, 256, 2500, "transposed"), (512, 512, 32256, "plain"),
                 (700, 260, 5000, "plain"),
                 (31232, 1536, 1536, "transposed"),
                 (8192, 1536, 4096, "plain"), (8000, 1500, 2500, "transposed"),
                 (6016, 1536, 4096, "plain"), (6000, 1500, 4000, "transposed"),
                 (640, 256, 2500, "transposed odd")]
# the route each of these takes on an H100 (132 SMs): ping-pong tiles for
# short K, split-K where tiles are few, cooperative tiles for long K on
# many tiles (ragged ones among them)
K2_BF16_ROUTES = {(2048, 1536, 1536): "tiles", (512, 512, 32256): "split-k",
                  (8192, 1536, 4096): "cooperative",
                  (8000, 1500, 2500): "cooperative",
                  (6016, 1536, 4096): "cooperative",
                  (6000, 1500, 4000): "cooperative"}


@pytest.mark.parametrize("mode", ["bf16", "bf16out"])
@pytest.mark.parametrize("m,n,k,layout", K2_BF16_CASES)
def test_k2_bf16_entry_matches_plain_on_card(card, m, n, k, layout, mode):
    g = torch.Generator(device=card).manual_seed(m + n + k)
    if layout == "odd":
        A = torch.randn(m, k + 3, generator=g, device=card).to(
            torch.bfloat16)[:, 3:]
    else:
        A = torch.randn(m, k, generator=g, device=card).to(torch.bfloat16)
    if layout == "transposed odd":
        B = torch.randn(n, k, generator=g, device=card).to(torch.bfloat16).T
    elif layout == "transposed":
        # the Cholesky's B: rows of a wider buffer (a row stride TMA
        # takes), viewed transposed
        ld = (k + 7) // 8 * 8 + 64
        B = torch.randn(n, ld, generator=g, device=card).to(
            torch.bfloat16)[:, 64:64 + k].T
    else:
        B = torch.randn(k, n, generator=g, device=card).to(torch.bfloat16)
    R = torch.randn(m, n, generator=g, device=card)
    if mode == "bf16out":
        R = R.to(torch.bfloat16)
    R0 = R.clone()
    ref = _sub_matmul_bigk_t(R, A, B, mode)
    before = (cuda_gemm.SUB_MATMUL_BIGK_LAUNCHES,
              cuda_gemm.SUB_MATMUL_BIGK_BF16_LAUNCHES,
              cuda_gemm.SUB_MATMUL_BIGK_BF16_COPIES,
              cuda_gemm.SUB_MATMUL_BIGK_BF16_SPLITK_LAUNCHES)
    got = cuda_gemm.sub_matmul_bigk_bf16(R, A, B, mode)
    torch.cuda.synchronize()
    last = dict(cuda_gemm.BF16_LAST)
    assert (cuda_gemm.SUB_MATMUL_BIGK_LAUNCHES,
            cuda_gemm.SUB_MATMUL_BIGK_BF16_LAUNCHES) == (before[0],
                                                         before[1] + 1)
    # a transposed B is read in place, K-major; copied first are only the
    # operands TMA cannot read: the odd A, and rows whose stride is not a
    # multiple of 16 bytes (A's k, a row-major B's n, a transposed B's k)
    assert last["b_layout"] == ("k-major" if layout == "transposed"
                                else "mn-major")
    b_copied = (k % 8 != 0 if layout == "transposed odd"
                else layout != "transposed" and n % 8 != 0)
    assert last["copied"] == ((("A",) if layout == "odd" or k % 8 else ())
                              + (("B",) if b_copied else ()))
    assert (cuda_gemm.SUB_MATMUL_BIGK_BF16_COPIES - before[2]
            == len(last["copied"]))
    splits = cuda_gemm.sub_matmul_bigk_bf16_splits(m, n, k)
    assert last["route"] == K2_BF16_ROUTES.get((m, n, k), last["route"])
    assert (last["route"] == "split-k") == (splits > 1)
    assert (cuda_gemm.SUB_MATMUL_BIGK_BF16_SPLITK_LAUNCHES - before[3]
            == int(splits > 1))
    assert torch.equal(R, R0) and got.dtype == R.dtype
    # the same bf16 operand values: fp32 summation order only (plus one
    # bf16 ulp of the result where R is bf16)
    tol = 1e-5 * float(torch.mm(A.float().abs(), B.float().abs()).max())
    d = (got.float() - ref.float()).abs()
    if mode == "bf16out":
        assert bool((d <= _bf16_ulp(ref) + tol).all())
    else:
        assert float(d.max()) <= tol
    assert torch.equal(got, cuda_gemm.sub_matmul_bigk_bf16(R, A, B, mode))


def test_k2_bf16_entry_checks_its_inputs(card):
    R = torch.zeros(64, 64, device=card)
    A = torch.zeros(64, 32, device=card, dtype=torch.bfloat16)
    B = torch.zeros(32, 64, device=card, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        cuda_gemm.sub_matmul_bigk_bf16(R, A, B, "high")
    with pytest.raises(TypeError):
        cuda_gemm.sub_matmul_bigk_bf16(R, A.float(), B, "bf16")
    with pytest.raises(TypeError):
        cuda_gemm.sub_matmul_bigk_bf16(R, A, B, "bf16out")   # R float32


STEPPED_N, STEPPED_V = 4096, 512


def _stepped_input(card, seed=5):
    g = torch.Generator(device=card).manual_seed(seed)
    return 5.0 + torch.rand(STEPPED_N, STEPPED_N, generator=g, device=card)


def test_stepped_flat_matches_flat_lu_on_card(card):
    """The stepped flat LU against lu_factor(scheme='flat') at 'highest':
    the same panel math on the same values, the same U12 spliced into the
    pivot rows, so the same pivots; the library's products sum in another
    order at the two drivers' different heights, and that roundoff
    compounds through the steps (F within 2e-4 of max|F| of the flat F
    at N = 4096, measured on an H100; held at 1e-3), and both meet the
    gate. A consumed CUDA input holds the factor in original row order."""
    from conflux_tpu_torch.lu.stepped import lu_factor_stepped

    A = _stepped_input(card)
    F0, p0 = lu_factor(A, v=STEPPED_V, scheme="flat")
    R = A.clone()
    before = _counts()
    F1, p1 = lu_factor_stepped(R, v=STEPPED_V, out="device")
    steps = STEPPED_N // STEPPED_V
    assert _counts()["k3"] - before["k3"] == 0       # 'highest': torch.mm
    assert torch.equal(p0, p1)
    assert (F0 - F1).abs().max() <= 1e-3 * F0.abs().max()
    assert torch.equal(R[p1], F1)
    assert lu_residual_blocked(A, F1, p1) <= 1e-6
    F2, p2 = lu_factor_stepped(A.clone(), v=STEPPED_V, precision="high",
                               out="host")
    assert isinstance(F2, np.ndarray)
    assert lu_residual_blocked(A, F2, p2) <= 1e-6
    assert _counts()["k3"] - before["k3"] == steps - 1


def test_stepped_cholesky_is_the_flat_cholesky_in_place_on_card(card):
    from conflux_tpu_torch.cholesky.stepped import cholesky_stepped

    g = torch.Generator(device=card).manual_seed(6)
    X = torch.rand(STEPPED_N, STEPPED_N, generator=g, device=card)
    S = (X + X.T) / 2
    S.diagonal().add_(float(STEPPED_N))
    L0 = cholesky(S, v=STEPPED_V)
    R = S.clone()
    L1 = cholesky_stepped(R, v=STEPPED_V, out="device")
    assert L1.data_ptr() == R.data_ptr()
    assert torch.equal(L0, L1)
    Lh = cholesky_stepped(S.clone(), v=STEPPED_V, out="host")
    np.testing.assert_array_equal(Lh, L0.cpu().numpy())
    assert cholesky_residual_blocked(S, Lh) <= 1e-6


def test_stepped_crout_is_the_crout_lu_on_card(card):
    from conflux_tpu_torch.lu.stepped import lu_factor_stepped

    A = _stepped_input(card, seed=7)
    F0, p0 = lu_factor(A, v=STEPPED_V, precision="high", scheme="crout")
    F1, p1 = lu_factor_stepped(A.clone(), v=STEPPED_V, precision="high",
                               scheme="crout", out="device")
    assert torch.equal(p0, p1) and torch.equal(F0, F1)


def _counts():
    return {"k3": cuda_gemm.SCHUR_UPDATE_LAUNCHES}


# the pivot-triangle solve (csrc/panel_trsm.cu): n the panel's block
# widths (32, Cholesky's 64, a ragged 96, crout's 128) and its group width
# 512; r the rows solved for
TRSM_N = [32, 64, 96, 128, 512]
TRSM_R = [1, 128, 384, 1024]
_TRIANGLES = {}


def _pivot_triangle(n, dtype):
    """lu [n, n] column-major as the panel forms it (on the CPU): the merged
    factors of the pivot rows that partial pivoting selects from a random
    [2n, n] block, and kappa_inf(L) from float64."""
    if (n, dtype) not in _TRIANGLES:
        rng = np.random.default_rng(n)
        block = torch.from_numpy(rng.standard_normal((2 * n, n))).to(dtype)
        _, _, lu = select_pivots(block, torch.ones(2 * n, dtype=torch.bool),
                                 n, block=128)
        L = torch.tril(lu.double(), -1) + torch.eye(n, dtype=torch.float64)
        kappa = float(L.abs().sum(1).max()
                      * torch.linalg.inv(L).abs().sum(1).max())
        _TRIANGLES[n, dtype] = lu.T.contiguous(), kappa
    return _TRIANGLES[n, dtype]


@pytest.mark.parametrize("group", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("r", TRSM_R)
@pytest.mark.parametrize("n", TRSM_N)
def test_pivot_solve_matches_plain_on_card(card, n, r, dtype, group):
    luT, kappa = _pivot_triangle(n, dtype)
    lu = luT.to(card).T
    B = torch.from_numpy(np.random.default_rng(n + r).standard_normal(
        (r, n))).to(card, dtype)
    before = cuda_trsm.LAUNCHES
    X = _pivot_solve_t(B, lu, group)
    torch.cuda.synchronize()
    assert cuda_trsm.LAUNCHES == before + 1
    # the plain version on the same CUDA tensors: the explicit-inverse
    # chain of a block's update or the blocked substitution of a group's
    ref = _pivot_solve_plain(B, lu, group)
    L = torch.tril(lu.double(), -1) + torch.eye(n, dtype=torch.float64,
                                                device=card)
    exact = torch.linalg.solve_triangular(L.T, B.double(), upper=True,
                                          left=False)
    # a triangular solve's forward error is of the order of eps kappa(L)
    # max|B| (the plain versions stay under a tenth of it on the CPU); each
    # side within it of the float64 solve, so within twice of each other
    tol = torch.finfo(dtype).eps * kappa * float(B.abs().max())
    assert float((X.double() - exact).abs().max()) <= tol
    assert float((X - ref).abs().max()) <= 2 * tol
    assert torch.equal(X, cuda_trsm.solve_unit_lower_t(B, lu))


def test_pivot_solve_checks_its_inputs(card):
    B = torch.zeros(8, 64, device=card)
    lu = torch.eye(64, device=card).T
    before = cuda_trsm.LAUNCHES
    with pytest.raises(ValueError, match="512"):
        cuda_trsm.solve_unit_lower_t(torch.zeros(8, 513, device=card),
                                     torch.eye(513, device=card))
    with pytest.raises(ValueError, match="contiguous"):
        cuda_trsm.solve_unit_lower_t(torch.zeros(64, 8, device=card).T, lu)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_trsm.solve_unit_lower_t(B, torch.rand(64, 64, device=card))
    with pytest.raises(ValueError, match="contiguous"):
        cuda_trsm.solve_unit_lower_t(
            B, torch.zeros(128, 128, device=card)[:64, :64].T)
    with pytest.raises(TypeError):
        cuda_trsm.solve_unit_lower_t(B.half(), lu.half())
    with pytest.raises(ValueError, match="CUDA"):
        cuda_trsm.solve_unit_lower_t(B.cpu(), lu.cpu())
    assert cuda_trsm.LAUNCHES == before


def _solves_per_panel(w, block):
    """Pivot-triangle solves of one w-wide panel in `block`-wide K1 blocks
    (ops/panel._lu_select_loop_t): one per deferred update."""
    return sum(torch_onehot_panel.updates_of(w, block))


def test_crout_at_4096_solves_pivot_triangles_on_card(card):
    # v = 1536 'high', the main path's call: every step's panel solves in
    # the kernel, 9 + 2 times for a full 1536-wide panel
    n, v = 4096, 1536
    g = torch.Generator(device=card).manual_seed(11)
    A = torch.randn(n, n, generator=g, device=card)
    before = cuda_trsm.LAUNCHES
    F, perm = lu_factor(A, v=v, precision="high", scheme="crout")
    torch.cuda.synchronize()
    assert _solves_per_panel(1536, 128) == 9 + 2
    assert cuda_trsm.LAUNCHES - before == sum(
        _solves_per_panel(min(v, n - k), 128) for k in range(0, n, v))
    assert torch.equal(torch.sort(perm).values, torch.arange(n, device=card))
    assert lu_residual_blocked(A, F, perm) <= 1e-6


def test_cholesky_at_4096_solves_pivot_triangles_on_card(card):
    # each [w, w] tile's unpivoted LU in 64-wide blocks: 21 + 2 solves for
    # a full 1536-wide tile
    n, v = 4096, 1536
    g = torch.Generator(device=card).manual_seed(12)
    X = torch.rand(n, n, generator=g, device=card)
    A = (X + X.T) / 2 + n * torch.eye(n, device=card)
    before = cuda_trsm.LAUNCHES
    L = cholesky(A, v=v, precision="high")
    torch.cuda.synchronize()
    assert _solves_per_panel(1536, 64) == 21 + 2
    assert cuda_trsm.LAUNCHES - before == sum(
        _solves_per_panel(min(v, n - k), 64) for k in range(0, n, v))
    assert torch.equal(L, torch.tril(L))
    assert cholesky_residual_blocked(A, L) <= 1e-6


# crout's winners' solve (ops/tri.solve_lower_rows with csrc/lower_solve.cu
# on the diagonal blocks) at the cells' shapes: w = 1536 rows, c = N - k - w
# columns at each step with k + w < N, N = 32768 (21 solves) and 16384 (10)
WINNERS_W = 1536
WINNERS_C = [n - k - WINNERS_W for n in (32768, 16384)
             for k in range(0, n, WINNERS_W) if k + WINNERS_W < n]


def _winners_solve(card, c, dtype, seed=0):
    """(lu row-major on the card, as the step loop leaves it; B [W, c];
    the float64 solve; 2 eps kappa_inf(L) max|B|)."""
    luT, kappa = _pivot_triangle(WINNERS_W, dtype)
    lu = luT.T.contiguous().to(card)
    B = torch.from_numpy(np.random.default_rng(c + seed).standard_normal(
        (WINNERS_W, c))).to(card, dtype)
    L = torch.tril(lu.double(), -1) + torch.eye(
        WINNERS_W, dtype=torch.float64, device=card)
    ref = torch.linalg.solve_triangular(L, B.double(), upper=False,
                                        unitriangular=True)
    return lu, B, ref, 2 * torch.finfo(dtype).eps * kappa * float(
        B.abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("c", WINNERS_C)
def test_winners_solve_matches_plain_and_float64_on_card(card, c, dtype):
    lu, B, ref, tol = _winners_solve(card, c, dtype)
    X = torch.empty_like(B)
    before = cuda_lower_solve.LAUNCHES
    tri.solve_lower_rows(lu, B.clone(), X, cuda_lower_solve.solve_diag)
    torch.cuda.synchronize()
    assert cuda_lower_solve.LAUNCHES - before == -(
        -WINNERS_W // tri._LSOLVE_ROWS)
    # the plain version on the same CUDA tensors: row-by-row substitution
    # on the diagonal blocks
    plain = torch.empty_like(B)
    tri.solve_lower_rows(lu, B.clone(), plain)
    assert float((X - plain).abs().max()) <= tol
    assert float((X.double() - ref).abs().max()) <= tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("c", [WINNERS_C[0], WINNERS_C[-1]])
def test_winners_solve_repeats_its_bits_on_card(card, c, dtype):
    lu, B, _, _ = _winners_solve(card, c, dtype, seed=1)
    runs = []
    for _ in range(2):
        X = torch.empty_like(B)
        tri.solve_lower_rows(lu, B.clone(), X, cuda_lower_solve.solve_diag)
        runs.append(X)
    torch.cuda.synchronize()
    assert torch.equal(runs[0], runs[1])


@pytest.mark.parametrize("layout", ["column-major", "strided out"])
def test_winners_solve_layouts_on_card(card, layout):
    # bf16 storage's lu_top is column-major; the factor's slice has ld > c
    c = 2560
    lu, B, ref, tol = _winners_solve(card, c, torch.float32, seed=2)
    if layout == "column-major":
        lu = lu.T.contiguous().T
        X = torch.empty_like(B)
    else:
        F = torch.zeros(WINNERS_W + 4, c + 100, device=card)
        X = F[4:, 100:]
    tri.trsm_left_lower_unit_into(lu, B.clone(), X)
    torch.cuda.synchronize()
    assert float((X.double() - ref).abs().max()) <= tol
    if layout == "strided out":
        assert not bool(F[:4].any()) and not bool(F[:, :100].any())


@pytest.mark.parametrize("c", WINNERS_C)
def test_winners_solve_kernels_per_call_on_card(card, c):
    # every kernel of one call, the library products' split-K reduces
    # included, at most 12
    from torch.profiler import DeviceType, ProfilerActivity, profile

    lu, B, _, _ = _winners_solve(card, c, torch.float32)
    X = torch.empty_like(B)
    tri.trsm_left_lower_unit_into(lu, B.clone(), X)
    Bw = B.clone()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        tri.trsm_left_lower_unit_into(lu, Bw, X)
        torch.cuda.synchronize()
    kernels = sum(e.count for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA)
    assert 1 <= kernels <= 12


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_crout_at_4096_solves_winners_rows_in_the_kernel(card, dtype):
    # v = 1536 'high': two steps solve their winners' rows (c = 2560 and
    # 1024), 1536 / _LSOLVE_ROWS diagonal blocks each, in the dtypes that
    # take the kernel; float64 keeps the inverse chain
    n, v = 4096, 1536
    g = torch.Generator(device=card).manual_seed(13)
    A = torch.randn(n, n, generator=g, device=card, dtype=dtype)
    before = cuda_lower_solve.LAUNCHES
    F, perm = lu_factor(A, v=v, precision="high", scheme="crout")
    torch.cuda.synchronize()
    blocks = sum(-(-v // tri._LSOLVE_ROWS) for k in range(0, n, v)
                 if k + v < n)
    assert cuda_lower_solve.LAUNCHES - before == (
        blocks if dtype in tri._LSOLVE_DTYPES else 0)
    assert torch.equal(torch.sort(perm).values, torch.arange(n, device=card))
    assert lu_residual_blocked(A, F, perm) <= (
        1e-6 if dtype == torch.float32 else 1e-14)


def test_winners_solve_checks_its_inputs(card):
    lu = torch.eye(64, device=card)
    B = torch.zeros(64, 8, device=card)
    X = torch.empty_like(B)
    before = cuda_lower_solve.LAUNCHES
    solve = cuda_lower_solve.solve_diag
    with pytest.raises(ValueError, match="CUDA"):
        solve(lu.cpu(), B.cpu(), X.cpu())
    with pytest.raises(TypeError, match="float32 or float64"):
        solve(lu.bfloat16(), B.bfloat16(), X.bfloat16())
    with pytest.raises(TypeError, match="one dtype"):
        solve(lu, B.double(), X)
    with pytest.raises(ValueError, match="512"):
        solve(torch.eye(513, device=card), torch.zeros(513, 8, device=card),
              torch.zeros(513, 8, device=card))
    with pytest.raises(ValueError, match="c >= 1"):
        solve(lu, B[:, :0], X[:, :0])
    with pytest.raises(ValueError, match="shapes"):
        solve(lu, B, X[:, :4])
    with pytest.raises(ValueError, match="unit column stride"):
        solve(lu, torch.zeros(8, 64, device=card).T, X)
    with pytest.raises(ValueError, match="unit stride"):
        solve(torch.eye(128, device=card)[::2, ::2], B, X)
    with pytest.raises(ValueError, match="overlap"):
        solve(lu, B, B)
    assert cuda_lower_solve.LAUNCHES == before


def test_f64_crout_at_the_cells_size(card):
    """lu.f64.n32768's call (benchmark/configs/lu-f64.json) on one of its
    inputs: 41 f64 products through sub_dot and none through K2, K1 in
    double on its grid route for the 240 blocks wider than a cluster and
    on the cluster route for the last panel's 16, 21 x (9 + 2) + 3
    pivot-triangle solves, as many pivot-lane gathers and as many
    scatters (the 'gather' compaction finishes its pivot lanes); the
    phase spans tile lu.factor (host and
    stream time, 99 % or more, as on the float32 path); the cell's judge
    passes it."""
    from benchmark import spec, work

    cell = spec.load_cell("lu.f64.n32768")
    drv, cfg, n = cell.driver, cell.config, cell.traffic["n"]
    v = cfg["call"]["v"]
    factor = drv.prepare(cfg, n, card)
    A = drv.make_input(cfg, n, 2 ** 31 + 21, 0, card)
    factor(A)                      # builds and warms every kernel
    torch.cuda.synchronize()
    counters = ((gemm, "SUB_DOT_F64_PRODUCTS"),
                (cuda_panel, "LAUNCHES_F64_GRID"),
                (cuda_panel, "LAUNCHES_F64_CLUSTER"),
                (cuda_panel, "LAUNCHES_F64_TILE"),
                (cuda_panel, "LAUNCHES"), (cuda_trsm, "LAUNCHES"),
                (cuda_lanes, "GATHER_LAUNCHES"),
                (cuda_lanes, "SCATTER_LAUNCHES"),
                (cuda_gemm, "SUB_MATMUL_BIGK_LAUNCHES"),
                (cuda_gemm, "SUB_MATMUL_BIGK_BF16_LAUNCHES"))
    before = [getattr(mod, name) for mod, name in counters]
    profiler.PC()
    profiler.enable(True)
    try:
        out = factor(A)
        torch.cuda.synchronize()
        table = profiler.snapshot()
    finally:
        profiler.enable(False)
        profiler.PC()
    got = [getattr(mod, name) - b for (mod, name), b in zip(counters, before)]
    assert len(work.k2_calls("crout", n, v)) == 41
    updates = 21 * (9 + 2) + 3
    assert got == [41, 240, 16, 0, 0, updates, updates, updates, 0, 0]
    _, host, dev = table["lu.factor"]
    phases = [table[f"lu.factor/lu.{p}"]
              for p in ("update", "panel", "solve", "compact")]
    assert sum(h for _, h, _ in phases) >= 0.99 * host
    assert sum(d for _, _, d in phases) >= 0.99 * dev
    assert all(c == -(-n // v) for c, _, _ in phases)
    got = drv.readings(cfg, A, out)
    assert all(got[k] <= lim["limit"] for k, lim in cell.limits.items()), got


def _lane_case(card, dtype, seed):
    """A [300, 2000] source as a column slice of a wider tensor (row stride
    2048), 96 pivot lanes whose ok entries are distinct and whose not-ok
    ones repeat ok lanes and each other, and [300, 96] values."""
    rng = np.random.default_rng(seed)
    wide = torch.from_numpy(rng.standard_normal((300, 2048))).to(card, dtype)
    lanes = rng.permutation(2000)[:96]
    ok = np.ones(96, bool)
    ok[60:] = False
    lanes[60:] = lanes[rng.integers(0, 70, 36)]
    vals = torch.from_numpy(rng.standard_normal((300, 96))).to(card, dtype)
    return (wide[:, 24:2024], torch.from_numpy(lanes).to(card),
            torch.from_numpy(ok).to(card), vals)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_lane_moves_match_plain_on_card(card, dtype):
    # the kernels against the plain versions on copies of the same inputs,
    # bit for bit: an entry not ok reads 0 and writes nothing
    src, piv, ok, vals = _lane_case(card, dtype, 31)
    before = (cuda_lanes.GATHER_LAUNCHES, cuda_lanes.SCATTER_LAUNCHES)
    got = _gather_lanes(src, piv, ok)
    dst = src.clone()
    _scatter_lanes(dst, piv, ok, vals)
    torch.cuda.synchronize()
    assert (cuda_lanes.GATHER_LAUNCHES - before[0],
            cuda_lanes.SCATTER_LAUNCHES - before[1]) == (1, 1)
    assert got.is_contiguous() and got.shape == (300, 96)
    assert torch.equal(got.cpu(), _gather_lanes(src.cpu(), piv.cpu(),
                                                ok.cpu()))
    want = src.cpu().clone()
    _scatter_lanes(want, piv.cpu(), ok.cpu(), vals.cpu())
    assert torch.equal(dst.cpu(), want)
    # into a strided destination, leaving its other columns as they were
    wide = torch.zeros(300, 2048, device=card, dtype=dtype)
    _scatter_lanes(wide[:, 24:2024], piv, ok, vals)
    want = torch.zeros(300, 2000, dtype=dtype)
    _scatter_lanes(want, piv.cpu(), ok.cpu(), vals.cpu())
    assert torch.equal(wide[:, 24:2024].cpu(), want)
    assert not bool(wide[:, :24].any()) and not bool(wide[:, 2024:].any())


def test_lane_moves_check_their_inputs(card):
    src, piv, ok, vals = _lane_case(card, torch.float32, 32)
    before = (cuda_lanes.GATHER_LAUNCHES, cuda_lanes.SCATTER_LAUNCHES)
    with pytest.raises(TypeError):
        cuda_lanes.gather_lanes(src.half(), piv, ok)
    with pytest.raises(TypeError):
        cuda_lanes.scatter_lanes_(src, piv, ok, vals.double())
    with pytest.raises(ValueError, match="int64"):
        cuda_lanes.gather_lanes(src, piv.int(), ok)
    with pytest.raises(ValueError, match="int64"):
        cuda_lanes.gather_lanes(src, piv, ok[:10])
    with pytest.raises(ValueError, match="contiguous"):
        cuda_lanes.scatter_lanes_(src, piv, ok,
                                  torch.zeros(96, 300, device=card).T)
    with pytest.raises(ValueError, match="unit lane stride"):
        cuda_lanes.gather_lanes(src.T, piv, ok)
    with pytest.raises(ValueError, match="dense side"):
        cuda_lanes.scatter_lanes_(src, piv, ok, vals[:10])
    with pytest.raises(ValueError, match="not on"):
        cuda_lanes.gather_lanes(src, piv.cpu(), ok)
    assert (cuda_lanes.GATHER_LAUNCHES,
            cuda_lanes.SCATTER_LAUNCHES) == before


@pytest.mark.parametrize("rows", ["all", "fewer"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_select_loop_equals_onehot_formulation_on_card(card, dtype, rows):
    # a crout panel [8192, 1536] in 128-wide blocks with its pivot lanes
    # finished: the loop's index moves give the one-hot products' values,
    # so piv, ok and Pt equal the one-hot formulation's bit for bit, with
    # the same K1 and pivot-triangle kernels; 'fewer' leaves 1000 rows
    # active, so the later blocks' entries are not ok
    m, npiv, block = 8192, 1536, 128
    g = torch.Generator(device=card).manual_seed(41)
    panel = torch.randn(m, npiv, generator=g, device=card).to(dtype)
    active = torch.ones(m, dtype=torch.bool, device=card)
    if rows == "fewer":
        active[torch.randperm(m, generator=g, device=card)[1000:]] = False
    before = (cuda_lanes.GATHER_LAUNCHES, cuda_lanes.SCATTER_LAUNCHES)
    with ieee_fp32():
        got = _lu_select_loop_t(panel, active, npiv, False, block=block,
                                finish=True)
        torch.cuda.synchronize()
        moved = (cuda_lanes.GATHER_LAUNCHES - before[0],
                 cuda_lanes.SCATTER_LAUNCHES - before[1])
        ref = torch_onehot_panel.onehot_select_loop_t(
            panel, active, npiv, False, block=block, finish=True)
    inner, outer = torch_onehot_panel.updates_of(npiv, block)
    assert (inner, outer) == (9, 2)
    assert moved == (inner + outer, inner + outer)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    assert int(got[1].sum()) == (npiv if rows == "all" else 1000)
