"""Card tests of the 2.5D LU over NCCL on four cards, one rank each (the
benchmark cell lu25d.n16384.p4's path); each skips with fewer than four
cards. This file imports no jax:

    python -m pytest tests/test_torch_lu25d_cuda.py -m cuda --noconftest -q
"""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

import torch_ranks
from benchmark import reference
from benchmark.drivers import lu25d_plain
from conflux_tpu_torch.comm import AXES
from conflux_tpu_torch.launch import run_ranks

N, V = 4096, 512
GRID = (2, 2, 1)
EPS = float(np.finfo(np.float32).eps)
# the pivots the program and the plain CALU share on each parity input:
# on the random normal one (seed 41) the fp32 program resolves a near tie
# at pivot 1030 the other way than the plain CALU, which in fp32 and in
# float64 agrees with itself up to pivot 1860 (PERF.md §7)
SHARED = {"normal": 1030, "dominant": N}


def _four_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA cards")


def _input(seed):
    return torch.randn(N, N, generator=torch.Generator().manual_seed(seed))


def _dominant(seed):
    """(A, rows): a random matrix with N on the diagonal, its rows in a
    random order, and the rows that hold the diagonal of columns 0, 1,
    ...: the pivots any partial or tournament pivoting picks, by margins
    of about N over the rest of each column at every step."""
    g = torch.Generator().manual_seed(seed)
    perm = torch.randperm(N, generator=g)
    A = (torch.randn(N, N, generator=g) + N * torch.eye(N))[perm]
    return A, torch.argsort(perm).numpy()


@pytest.fixture(scope="module")
def parity():
    """Each parity input, factored on four cards over NCCL at 'highest'
    without a row rebalance (rowpart 0), and by the plain CALU on one
    card: {case: (A, F, piv, Fp, pp)}."""
    _four_cards()
    cases = {"normal": _input(41), "dominant": _dominant(43)[0]}
    got = run_ranks(4, torch_ranks.lu25d_cases,
                    {"device": "cuda", "parity": [(A, V, "windowed", 0)
                                                  for A in cases.values()]},
                    backend="nccl", timeout=600)
    assert all(r["jax_free"] for r in got)
    out = {}
    for (case, A), (F, piv) in zip(cases.items(), got[0]["parity"]):
        Fp, pp = lu25d_plain.calu(A.cuda(), V, GRID[0])
        out[case] = (A, F, piv, Fp.cpu().numpy(), pp.cpu().numpy())
    return out


def _resid(A, F, perm) -> float:
    """The reference's backward error ||A[perm] - LU||_F / (N ||A||_F)."""
    return reference.lu_readings(A, torch.as_tensor(F),
                                 torch.as_tensor(perm))["resid_f"]


def _entry_err(F, piv, Fp, pp, K: int) -> float:
    """The largest difference of F from the plain's Fp where the first K
    pivots (equal in both) settle them, each entry against the largest
    entry of its own part of the plain's row: F's first K rows by part
    (L left of the diagonal, the pivot, U right of it), and the first K
    columns of L of every later row, matched by its row of A."""
    F, Fp = F.astype(np.float64), Fp.astype(np.float64)
    i, j = np.arange(K)[:, None], np.arange(N)[None, :]
    err = 0.0
    for part in (j < i, j == i, j > i):
        scale = np.where(part, np.abs(Fp[:K]), 0).max(1, keepdims=True)
        diff = np.where(part, np.abs(F[:K] - Fp[:K]), 0)
        rows = scale[:, 0] > 0
        err = max(err, float((diff[rows] / scale[rows]).max()))
    if K < N:
        L, Lp = np.zeros((N, K)), np.zeros((N, K))
        L[piv[K:]], Lp[pp[K:]] = F[K:, :K], Fp[K:, :K]
        L, Lp = L[piv[K:]], Lp[piv[K:]]
        scale = np.abs(Lp).max(1, keepdims=True)
        err = max(err, float((np.abs(L - Lp) / scale).max()))
    return err


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(SHARED))
def test_program_over_nccl_picks_the_plain_calus_pivots(parity, case):
    """The program on four cards over NCCL against the plain CALU
    (benchmark/drivers/lu25d_plain.py, on one card) at 'highest' without
    a row rebalance: the same pivots up to the input's first near tie
    (all of them on the diagonally dominant input, whose pivots win by
    margins of about N); each factor meets the reference's backward error
    gate, 1e-6; and F agrees with the plain's F within 2 N eps of the
    scale of each entry's part of its row, as far as the shared pivots
    settle it (the whole panels before the tie). The CPU parity tests
    hold N = 256-512; on the CPU at this N the per-entry difference is
    8e-5 on the random normal input and 2.4e-6 on the dominant one."""
    A, F, piv, Fp, pp = parity[case]
    shared = SHARED[case]
    assert np.array_equal(piv[:shared], pp[:shared])
    if case == "dominant":
        assert np.array_equal(piv, _dominant(43)[1])
    assert _resid(A, F, piv) <= 1e-6
    assert _resid(A, Fp, pp) <= 1e-6
    err = _entry_err(F, piv, Fp, pp, shared // V * V)
    assert err <= 2 * N * EPS, err


def _launches(rec) -> int:
    """The NCCL kernels one recorded collective launches on a rank of the
    (2, 2, 1) grid: none over a group of one rank (the 'z' psums), one
    for every other collective (a ppermute's send and receive are one
    batch, one kernel)."""
    return int(math.prod(dict(zip(AXES, GRID))[a] for a in rec.axes) > 1)


@pytest.mark.cuda
def test_nccl_launches_of_a_factorization_match_the_record():
    """Each collective that reaches the card is one NCCL kernel, and the
    trace also holds one device-side annotation `nccl:<op>` (c10d's
    user-scope range) for each: the benchmark's NCCL readers halve the
    group (benchmark/metrics/nccl_ms.py)."""
    _four_cards()
    got = run_ranks(4, torch_ranks.lu25d_nccl_launches, _input(42), V,
                    backend="nccl", timeout=600)
    for r in got:
        want = sum(_launches(rec) for rec in r["records"])
        kernels = [k for k in r["nccl"] if k.startswith("ncclDevKernel")]
        notes = [k for k in r["nccl"] if k.startswith("nccl:")]
        assert len(kernels) == len(notes) == want > 0
        assert len(r["nccl"]) == 2 * want
