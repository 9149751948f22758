"""Tests of the PyTorch port that need a CUDA card: the hand-written kernel
K1 (conflux_tpu_torch/csrc/rank1_panel.cu) against its plain PyTorch
version, and the crout LU end to end on the card. Without a card every
test here skips.

This file imports no jax, so it also runs where jax is not installed:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import numpy as np
import pytest
import torch

from conflux_tpu_torch.lu.single import lu_factor
from conflux_tpu_torch.ops import cuda_panel
from conflux_tpu_torch.ops.panel import _rank1_block_t
from conflux_tpu_torch.validation import lu_residual_blocked

pytestmark = pytest.mark.cuda

MODES = ["unforced", "forced", "finish"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (K1 has no CPU mode)")
    return torch.device("cuda")


def _block(m, w, mode, seed):
    """[w, m] transposed block and [1, m] availability from a seed, one
    lane masked; forced mode gets diagonally dominant leading lanes."""
    rng = np.random.default_rng(seed)
    Mt = rng.standard_normal((w, m)).astype(np.float32)
    if mode == "forced":
        Mt[np.arange(w), np.arange(w)] += w
    avail = np.ones((1, m), np.float32)
    avail[0, m - 3] = 0.0
    return Mt, avail


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("m", [1000, 32768])
def test_kernel_matches_plain_on_card(card, m, mode):
    Mt, avail = _block(m, 128, mode, seed=m)
    Mt = torch.from_numpy(Mt).to(card)
    avail = torch.from_numpy(avail).to(card)
    forced, finish = mode == "forced", mode == "finish"
    ref = _rank1_block_t(Mt, avail, 0, forced, finish)
    before = cuda_panel.LAUNCHES
    got = cuda_panel.rank1_block_t(Mt, avail, forced, 0, finish)
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
