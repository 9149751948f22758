"""Tests of the PyTorch port that need a CUDA card: the hand-written kernels
K1 (conflux_tpu_torch/csrc/rank1_panel.cu), K3 (csrc/schur_update.cu), K2
and K4 (csrc/bigk_gemm.cu), K5 and K6 (csrc/row_move.cu) against their
plain PyTorch versions, and the crout LU (all three compactions), the flat
LU and the Cholesky end to end on the card. Without a card every test here
skips.

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
    ref = _rank1_block_t(Mt, avail, j0, forced, finish)
    before = cuda_panel.LAUNCHES
    got = cuda_panel.rank1_block_t(Mt, avail, forced, j0, finish)
    torch.cuda.synchronize()
    assert cuda_panel.LAUNCHES == before + 1
    assert torch.equal(ref[2], got[2].long())
    assert torch.equal(ref[3], got[3] > 0)
    assert torch.equal(ref[1], got[1])
    keep = torch.ones(m, dtype=torch.bool, device=card)
    if mode == "unforced":
        keep[ref[2]] = False      # stale in the plain version, unread
    # K1 applies the updates in another order than the two-level plain
    # version: agreement to a few fp32 roundings
    diff = (ref[0] - got[0])[:, keep].abs().max()
    assert diff <= 1e-4 * ref[0][:, keep].abs().max()


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
    # the main path at a small size: every panel block goes through K1
    n, v = 1024, 256
    g = torch.Generator(device=card).manual_seed(3)
    A = torch.randn(n, n, generator=g, device=card)
    before = cuda_panel.LAUNCHES
    F, perm = lu_factor(A, v=v, precision=precision)
    assert cuda_panel.LAUNCHES - before == (n // v) * (v // 128)
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
    ref = _schur_update_t(R.clone(), A, B, c0, mode, c1)
    before = cuda_gemm.SCHUR_UPDATE_LAUNCHES
    got = R.clone()
    assert cuda_gemm.schur_update(got, A, B, c0, mode, c1) is got
    torch.cuda.synchronize()
    assert cuda_gemm.SCHUR_UPDATE_LAUNCHES == before + 1
    assert torch.equal(got[:, :c0], R[:, :c0])
    assert torch.equal(got[:, c1:], R[:, c1:])
    tol = 1e-5 * float(torch.mm(A.abs(), B.abs()).max())
    d = (got[:, c0:c1].float() - ref[:, c0:c1].float()).abs()
    if mode == "bf16out":
        assert bool((d <= _bf16_ulp(ref[:, c0:c1]) + tol).all())
    else:
        assert float(d.max()) <= tol


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
    n, v = 1024, 256
    g = torch.Generator(device=card).manual_seed(5)
    X = torch.rand(n, n, generator=g, device=card)
    A = (X + X.T) / 2 + n * torch.eye(n, device=card)
    before = cuda_panel.LAUNCHES
    L = cholesky(A, v=v, precision="high")
    torch.cuda.synchronize()
    assert cuda_panel.LAUNCHES - before == (n // v) * (v // 64)
    assert torch.equal(L, torch.tril(L))
    assert cholesky_residual_blocked(A, L) <= 1e-6


# K2 (m, n, k): a tile-aligned call with enough tiles to run unsplit, a
# ragged one with a long K that the kernel splits across blocks, and R and
# A as strided column slices
K2_CASES = [(2048, 2048, 512), (300, 200, 4096), (1000, 37, 1500)]


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
    before = cuda_gemm.SUB_MATMUL_BIGK_LAUNCHES
    got = cuda_gemm.sub_matmul_bigk(R, A, B, mode)
    torch.cuda.synchronize()
    assert cuda_gemm.SUB_MATMUL_BIGK_LAUNCHES == before + 1
    assert torch.equal(R, R0) and got.dtype == R.dtype
    tol = 1e-5 * float(torch.mm(A.abs(), B.abs()).max())
    d = (got.float() - ref.float()).abs()
    if mode == "bf16out":
        assert bool((d <= _bf16_ulp(ref) + tol).all())
    else:
        assert float(d.max()) <= tol
    # the same call twice gives the same bits (split-K sums in fixed order)
    assert torch.equal(got, cuda_gemm.sub_matmul_bigk(R, A, B, mode))


def test_k2_splits_k_only_short_of_tiles(card):
    assert cuda_gemm.sub_matmul_bigk_splits(2048, 2048, 512) == 1
    assert cuda_gemm.sub_matmul_bigk_splits(300, 200, 4096) > 1
    assert cuda_gemm.sub_matmul_bigk_splits(31232, 1536, 1536) == 1


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
