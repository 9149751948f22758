"""Tests of the PyTorch port that need a CUDA card: the hand-written kernels
K1 (conflux_tpu_torch/csrc/rank1_panel.cu), K3 (csrc/schur_update.cu), K2
and K4 (csrc/bigk_gemm.cu), K5 and K6 (csrc/row_move.cu) against their
plain PyTorch versions, the split pass of K3 and K2 against
ops/tri._split_hi_lo bit for bit, the routes of K1, K2, K3, K4 and K5/K6
by their launch counters, the crout LU (all three compactions), the flat
LU and the Cholesky end to end on the card, and the entry points' results
bit-identical whatever TF32 setting the caller chose. Without a card every
test here skips.

This file imports no jax, so it also runs where jax is not installed:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import numpy as np
import pytest
import torch

from conflux_tpu_torch.cholesky.single import cholesky
from conflux_tpu_torch.lu.single import lu_factor
from conflux_tpu_torch.ops import cuda_gemm, cuda_panel, cuda_scatter
from conflux_tpu_torch.ops.gemm import (
    _matmul_t,
    _schur_update_t,
    _sub_matmul_bigk_t,
)
from conflux_tpu_torch.ops.panel import _rank1_block_t
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
            cuda_panel.LAUNCHES_GRID, cuda_panel.LAUNCHES_TILE)


def _k1_check(Mt, avail, mode, j0, masked_read=True):
    """One K1 call against its plain version: the route its counters show
    (forced blocks up to w = 128 on the tile route; others on the cluster
    route up to cluster_max_m(w) lanes, the grid route past it), pivots,
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
    assert tuple(a - b for a, b in zip(_k1_counts(), before)) == (
        1, int(route == "cluster"), int(route == "grid"),
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
    F, perm = lu_factor(A, v=v, precision=precision)
    assert cuda_panel.LAUNCHES - before[0] == (n // v) * (v // 128)
    assert cuda_gemm.SUB_MATMUL_BIGK_WGMMA_LAUNCHES - before[1] == (
        2 * (n // v) - 3 if precision == "high" else 0)
    assert F.is_cuda and bool(torch.isfinite(F).all())
    assert torch.equal(torch.sort(perm).values, torch.arange(n, device=card))
    assert lu_residual_blocked(A, F, perm) <= 1e-6


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
    F, perm = lu_factor(A, v=v, precision=precision, compaction=compaction)
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
