"""`lu.single.auto_scheme` and the scheme 'auto' dispatch, on the CPU.

  * `auto_scheme(m)` is 'recursive' below `CROUT_FROM_M` rows and 'crout'
    from there;
  * with the threshold patched to 64, `lu_factor(A)` gives the bits of
    `lu_factor(A, scheme=auto_scheme(m))` on both sides of it, in float32
    and float64, through the scheme's own driver; bf16 storage runs crout
    whatever the threshold says;
  * a (1, 1, 1) grid's `lu_25d` (through `plu`) under 'tournament',
    'gather' and 'full' gives the bits of that single-device call, bf16
    storage those of crout; 'none' runs the rank program;
  * at 'highest' the port's default `lu_factor` holds to the JAX package's
    `lu_factor` run at the same scheme, and to its default call where the
    two packages' `auto_scheme` agree: pivots equal, F within 2e-5 of
    max|F| and the 1e-6 residual gate (the bounds of tests/test_torch_lu.py);
  * the recursive scheme's K1 blocks, counted on the CPU, are the ones
    chip_smoke.py derives from the recursion and holds the card to.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import conflux_tpu.lu.single as jsingle
from conflux_tpu_torch import interop, validation
from conflux_tpu_torch.grid import make_grid
from conflux_tpu_torch.layout import BlockCyclic, distribute
from conflux_tpu_torch.lu import p25d
from conflux_tpu_torch.lu import single as tsingle

GATE = 1e-6
F_TOL = 2e-5
PATCHED = 64
DRIVERS = {"recursive": "_getrf_rec", "crout": "_getrf_crout"}


@pytest.fixture
def rng():
    return np.random.default_rng(1414)


@pytest.mark.parametrize("at,want", [
    (lambda t: 1, "recursive"), (lambda t: t - 1, "recursive"),
    (lambda t: t, "crout"), (lambda t: 2 * t, "crout"),
], ids=["1", "T-1", "T", "2T"])
def test_auto_scheme_threshold(at, want):
    assert tsingle.auto_scheme(at(tsingle.CROUT_FROM_M)) == want


def _spy(monkeypatch, module, ran):
    """Record which scheme driver of `module` each call reaches; the
    recursive driver's calls of itself are not calls of their own."""
    depth = [0]
    for scheme, name in DRIVERS.items():
        inner = getattr(module, name)

        def spy(*args, _inner=inner, _scheme=scheme, **kwargs):
            if not depth[0]:
                ran.append(_scheme)
            depth[0] += 1
            try:
                return _inner(*args, **kwargs)
            finally:
                depth[0] -= 1

        monkeypatch.setattr(module, name, spy)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("m,scheme", [(48, "recursive"), (96, "crout")])
def test_auto_is_the_named_scheme_bit_for_bit(rng, monkeypatch, dtype, m,
                                              scheme):
    monkeypatch.setattr(tsingle, "CROUT_FROM_M", PATCHED)
    assert tsingle.auto_scheme(m) == scheme
    A = torch.from_numpy(rng.standard_normal((m, m))).to(dtype)
    ran = []
    _spy(monkeypatch, tsingle, ran)
    F, perm = tsingle.lu_factor(A, v=16, precision="high")
    assert ran[0] == scheme
    Fs, ps = tsingle.lu_factor(A, v=16, precision="high", scheme=scheme)
    assert torch.equal(perm, ps) and torch.equal(F, Fs)


@pytest.mark.parametrize("threshold", [1, 10 ** 9], ids=["crout", "recursive"])
def test_bf16_storage_runs_crout_whatever_the_threshold(rng, monkeypatch,
                                                        threshold):
    monkeypatch.setattr(tsingle, "CROUT_FROM_M", threshold)
    A = torch.from_numpy(5.0 + rng.random((96, 96))).to(torch.bfloat16)
    ran = []
    _spy(monkeypatch, tsingle, ran)
    F, perm = tsingle.lu_factor(A, v=16, precision="high")
    assert ran == ["crout"]
    Fc, pc = tsingle.lu_factor(A, v=16, precision="high", scheme="crout")
    assert torch.equal(perm, pc) and torch.equal(F, Fc)


@pytest.mark.parametrize("pivoting", ["tournament", "gather", "full"])
@pytest.mark.parametrize("m,scheme", [(48, "recursive"), (96, "crout")])
def test_one_rank_lu_25d_runs_the_auto_scheme(rng, monkeypatch, pivoting, m,
                                              scheme):
    monkeypatch.setattr(tsingle, "CROUT_FROM_M", PATCHED)
    A = rng.standard_normal((m, m)).astype(np.float32)
    ran = []
    _spy(monkeypatch, tsingle, ran)
    F, perm = p25d.plu(A, make_grid((1, 1, 1), device="cpu"), v=8,
                       pivoting=pivoting, precision="high")
    assert ran == [scheme]
    Fs, ps = tsingle.lu_factor(torch.from_numpy(A), v=8, precision="high",
                               scheme=tsingle.auto_scheme(m))
    assert torch.equal(perm, ps) and torch.equal(F, Fs)


def test_one_rank_lu_25d_bf16_storage_runs_crout(rng, monkeypatch):
    monkeypatch.setattr(tsingle, "CROUT_FROM_M", 10 ** 9)
    A = torch.from_numpy(5.0 + rng.random((48, 48))).to(torch.bfloat16)
    desc = BlockCyclic.create(48, 48, 8, make_grid((1, 1, 1), device="cpu"))
    ran = []
    _spy(monkeypatch, tsingle, ran)
    F, perm = p25d.lu_25d(distribute(A, desc), desc, "tournament", "high")
    assert ran == ["crout"]
    Fc, pc = tsingle.lu_factor(A, v=8, precision="high", scheme="crout")
    assert torch.equal(perm, pc) and torch.equal(F, Fc)


def test_one_rank_lu_25d_none_runs_the_rank_program(rng, monkeypatch):
    A = (rng.standard_normal((48, 48)) + 48 * np.eye(48)).astype(np.float32)
    desc = BlockCyclic.create(48, 48, 8, make_grid((1, 1, 1), device="cpu"))
    ran = []
    _spy(monkeypatch, tsingle, ran)
    F, perm = p25d.lu_25d(distribute(A, desc), desc, "none", "highest")
    assert ran == []
    assert validation.lu_residual_dense(A, F.numpy(), perm.numpy()) <= GATE


@pytest.mark.parametrize("m", [40, 96, 200])
def test_default_lu_factor_matches_jax_at_the_same_scheme(rng, m):
    A = rng.standard_normal((m, m)).astype(np.float32)
    Ft, pt = interop.factors_to_numpy(*tsingle.lu_factor(
        interop.from_numpy(A, device="cpu")))
    scheme = tsingle.auto_scheme(m)
    calls = [dict(scheme=scheme)]
    if jsingle.auto_scheme(m) == scheme:
        calls.append({})                  # the JAX default call itself
    for kw in calls:
        Fj, pj = jsingle.lu_factor(jnp.asarray(A), **kw)
        Fj, pj = np.asarray(Fj), np.asarray(pj)
        np.testing.assert_array_equal(pt, pj)
        assert np.abs(Ft - Fj).max() / np.abs(Fj).max() <= F_TOL
    assert validation.lu_residual_dense(A, Ft, pt) <= GATE


@pytest.mark.parametrize("n,v", [(520, 96), (384, 128)])
def test_recursive_k1_blocks_follow_the_recursion(rng, monkeypatch, n, v):
    # chip_smoke.py holds the card's recursive path to these blocks
    import chip_smoke
    from conflux_tpu_torch.ops import panel

    seen = []
    inner = panel._rank1_dispatch

    def spy(Bt, availf, j0, forced, finish=False):
        seen.append((Bt.shape[0], Bt.shape[1], forced))
        return inner(Bt, availf, j0, forced, finish)

    monkeypatch.setattr(panel, "_rank1_dispatch", spy)
    A = torch.from_numpy(rng.standard_normal((n, n)).astype(np.float32))
    tsingle.lu_factor(A, v=v, precision="high", scheme="recursive")
    assert seen == chip_smoke.k1_blocks("recursive", n, v)
