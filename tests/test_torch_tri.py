"""Parity of the PyTorch port's triangular layer (conflux_tpu_torch/ops/tri.py)
with the JAX reference (conflux_tpu/ops/tri.py), on the same numpy inputs.

Tolerances are normwise, max|diff| <= tol * max|ref|:
  * 'highest': both sides are IEEE fp32 with different summation orders
    (5e-6);
  * 'high': the JAX CPU backend does not split operands while the port
    runs the explicit bf16x3 split (5e-5; the split alone is ~5e-6 from
    the float64 product at these shapes);
  * 'bf16': bf16 operands, exact products, fp32 sums on both sides (5e-6);
  * 'bf16out': 'bf16' rounded once to bf16, so a result that lands on a
    rounding boundary may differ by one bf16 ulp (2^-8 relative).
The triangular inverses and solves are held to 1e-5 normwise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import conflux_tpu.ops.tri as jtri
import conflux_tpu_torch.ops.tri as ttri

_SCHUR_TOL = {"highest": 5e-6, "high": 5e-5, "bf16": 5e-6, "bf16out": 8e-3}


def _normwise(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / np.abs(ref).max()


def _tri(rng, n, lower=True, unit=False):
    """Random triangle with its off-diagonal scaled by 0.1 (random
    triangles are exponentially ill-conditioned otherwise)."""
    T = 0.1 * rng.standard_normal((n, n))
    T = np.tril(T, -1) if lower else np.triu(T, 1)
    d = np.ones(n) if unit else 1.0 + rng.random(n)
    return (T + np.diag(d)).astype(np.float32)


@pytest.mark.parametrize("mode", ["highest", "high", "bf16", "bf16out"])
@pytest.mark.parametrize("bt", [False, True])
def test_schur_dot_matches_jax(rng, mode, bt):
    a = rng.standard_normal((256, 512)).astype(np.float32)
    b = rng.standard_normal((512, 128)).astype(np.float32)
    if bt:
        b = np.ascontiguousarray(b.T)
    ref = jtri.schur_dot(jnp.asarray(a), jnp.asarray(b), mode, bt=bt)
    got = ttri.schur_dot(torch.from_numpy(a), torch.from_numpy(b), mode,
                         bt=bt)
    want_dtype = torch.bfloat16 if mode == "bf16out" else torch.float32
    assert got.dtype == want_dtype and tuple(got.shape) == (256, 128)
    ref = np.asarray(ref, np.float32)
    assert _normwise(got.float().numpy(), ref) <= _SCHUR_TOL[mode]


def test_schur_dot_high_is_f32_faithful(rng):
    # the bf16x3 split against the float64 product: ~16 mantissa bits of
    # each operand survive, so far better than one bf16 pass (~4e-3)
    a = rng.standard_normal((256, 512)).astype(np.float32)
    b = rng.standard_normal((512, 128)).astype(np.float32)
    got = ttri.schur_dot(torch.from_numpy(a), torch.from_numpy(b), "high")
    exact = a.astype(np.float64) @ b.astype(np.float64)
    assert _normwise(got.numpy(), exact) <= 2e-5


def test_schur_dot_rejects_unknown_mode():
    x = torch.ones(2, 2)
    with pytest.raises(ValueError):
        ttri.schur_dot(x, x, "tf32")


def test_split_hi_lo_keeps_nonzero_lo(rng):
    # the analog of tests/test_panel.py::test_split_hi_lo_survives_jit: the
    # low half must carry the next 8 mantissa bits, not fold to zero
    x = torch.from_numpy(rng.standard_normal((256, 256)).astype(np.float32))
    hi, lo = ttri._split_hi_lo(x)
    assert hi.dtype == torch.bfloat16 and lo.dtype == torch.bfloat16
    assert int(torch.count_nonzero(lo)) > lo.numel() // 2
    err = float((hi.float() + lo.float() - x).abs().max())
    assert err <= 2.0 ** -15, err


@pytest.mark.parametrize("mn", [(48, 48), (40, 24), (24, 40)])
def test_unit_lower_upper_match_jax(rng, mn):
    F = rng.standard_normal(mn).astype(np.float32)
    for jf, tf in ((jtri.unit_lower, ttri.unit_lower),
                   (jtri.upper, ttri.upper)):
        np.testing.assert_array_equal(
            tf(torch.from_numpy(F)).numpy(), np.asarray(jf(jnp.asarray(F))))


@pytest.mark.parametrize("n,unit,base", [(32, True, 32), (128, True, 32),
                                         (96, False, 32), (200, False, 128)])
def test_inv_lower_rec_matches_jax(rng, n, unit, base):
    L = _tri(rng, n, lower=True, unit=unit)
    ref = np.asarray(jtri._inv_lower_rec(jnp.asarray(L), unit, base))
    got = ttri._inv_lower_rec(torch.from_numpy(L), unit, base).numpy()
    assert _normwise(got, ref) <= 1e-5


@pytest.mark.parametrize("n", [20, 300])
@pytest.mark.parametrize("transpose", [False, True])
def test_inv_diag_blocks_matches_jax(rng, n, transpose):
    L = _tri(rng, n, lower=True, unit=True)
    ref = np.asarray(jtri._inv_diag_blocks(jnp.asarray(L), transpose))
    got = ttri._inv_diag_blocks(torch.from_numpy(L), transpose).numpy()
    assert _normwise(got, ref) <= 1e-5


@pytest.mark.parametrize("n,cols", [(24, 16), (300, 40), (600, 96)])
@pytest.mark.parametrize("method", ["invert", "solve"])
def test_trsm_left_lower_unit_matches_jax(rng, n, cols, method):
    L = _tri(rng, n, lower=True, unit=True)
    B = rng.standard_normal((n, cols)).astype(np.float32)
    ref = np.asarray(jtri.trsm_left_lower_unit(jnp.asarray(L), jnp.asarray(B),
                                               method=method))
    got = ttri.trsm_left_lower_unit(torch.from_numpy(L), torch.from_numpy(B),
                                    method=method).numpy()
    assert _normwise(got, ref) <= 1e-5


@pytest.mark.parametrize("n,rows", [(24, 16), (300, 40)])
@pytest.mark.parametrize("method", ["invert", "solve"])
def test_trsm_right_upper_matches_jax(rng, n, rows, method):
    U = _tri(rng, n, lower=False, unit=False)
    B = rng.standard_normal((rows, n)).astype(np.float32)
    ref = np.asarray(jtri.trsm_right_upper(jnp.asarray(B), jnp.asarray(U),
                                           method=method))
    got = ttri.trsm_right_upper(torch.from_numpy(B), torch.from_numpy(U),
                                method=method).numpy()
    assert _normwise(got, ref) <= 1e-5


@pytest.mark.parametrize("n,rows", [(24, 16), (300, 40), (600, 96)])
@pytest.mark.parametrize("method", ["invert", "solve"])
def test_trsm_right_lower_t_matches_jax(rng, n, rows, method):
    L = _tri(rng, n, lower=True, unit=False)
    B = rng.standard_normal((rows, n)).astype(np.float32)
    ref = np.asarray(jtri.trsm_right_lower_t(jnp.asarray(B), jnp.asarray(L),
                                             method=method))
    got = ttri.trsm_right_lower_t(torch.from_numpy(B), torch.from_numpy(L),
                                  method=method).numpy()
    assert _normwise(got, ref) <= 1e-5
