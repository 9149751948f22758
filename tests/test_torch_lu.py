"""Parity of the PyTorch port's crout LU (conflux_tpu_torch/lu/single.py)
with the JAX reference (conflux_tpu/lu/single.py), on the same numpy
inputs, plus the port's residual gates, state interop and import hygiene.

At 'highest' both packages run IEEE fp32 with the same operation order up
to the summation order of the matrix products: perm must be identical.
Each package's F lies within ~1e-5 * max|F| of a float64 run of the same
algorithm (measured 1e-6 to 1e-5 on these shapes for either package), so
the port is held to its own float64 run at 1e-5 and to the JAX F at 2e-5,
the sum of two such independent fp32 errors. At 'high' the port runs the
explicit bf16x3 split while the JAX CPU backend does not split, so only
the reference's gate ||PA - LU|| / (N ||A||) <= 1e-6 is required of both;
how many pivots agree is reported.

The flat and recursive schemes are held the same way at 'highest'
(identical perms, F within 2e-5 of max|F|). At 'high' the port's flat path
runs K3's plain version and the JAX flat path is run through its Pallas K3
in interpret mode (its CPU gate bypassed, as tests/test_single_device.py
does); both take the same split operands, and each must meet a residual
< 1e-8 on the `5 + U(0,1)` input.
"""

import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import conflux_tpu.lu.single as jsingle
import conflux_tpu.validation as jvalidation
import conflux_tpu_torch
from conflux_tpu_torch import interop, validation
from conflux_tpu_torch.errors import ConfluxError, ErrorCode
from conflux_tpu_torch.lu import single as tsingle

GATE = 1e-6
CASES = [(128, 128, 32, 1), (160, 96, 32, 2), (140, 140, 32, 0)]
SCHEME_SHAPES = [(m, n) for m, n, _, _ in CASES] + [(200, 120)]


def _both(A, v, precision, partition):
    Fj, pj = jsingle.lu_factor(jnp.asarray(A), v=v, precision=precision,
                               scheme="crout", partition=partition)
    Ft, pt = tsingle.lu_factor(interop.from_numpy(A), v=v,
                               precision=precision, scheme="crout",
                               partition=partition)
    Ft, pt = interop.factors_to_numpy(Ft, pt)
    return (np.asarray(Fj), np.asarray(pj)), (Ft, pt)


@pytest.mark.parametrize("m,n,v,partition", CASES)
def test_crout_highest_matches_jax(rng, m, n, v, partition):
    A = rng.standard_normal((m, n)).astype(np.float32)
    (Fj, pj), (Ft, pt) = _both(A, v, "highest", partition)
    assert pt.dtype == np.int64 and Ft.shape == (m, n)
    np.testing.assert_array_equal(pt, pj)
    F64, p64 = tsingle._getrf_crout(torch.from_numpy(A).double(), v,
                                    "highest", partition)
    np.testing.assert_array_equal(pt, p64.numpy())
    F64 = F64.numpy()
    assert np.abs(Ft - F64).max() / np.abs(F64).max() <= 1e-5
    assert np.abs(Ft - Fj).max() / np.abs(Fj).max() <= 2e-5
    assert validation.lu_residual_dense(A, Ft, pt) <= GATE


@pytest.mark.parametrize("m,n,v,partition", CASES)
def test_crout_high_meets_gate(rng, m, n, v, partition):
    A = rng.standard_normal((m, n)).astype(np.float32)
    (Fj, pj), (Ft, pt) = _both(A, v, "high", partition)
    res_j = jvalidation.lu_residual_dense(A, Fj, pj)
    res_t = validation.lu_residual_dense(A, Ft, pt)
    print(f"[{m}x{n} v={v} p={partition}] perm agreement "
          f"{np.mean(pt == pj):.3f}, residual jax {res_j:.2e} port {res_t:.2e}")
    assert res_j <= GATE and res_t <= GATE
    assert np.array_equal(np.sort(pt), np.arange(m))


@pytest.mark.parametrize("partition", [1, 2])
def test_lu_factor_leaves_input_unchanged(rng, partition):
    # the port updates its working buffer in place; the caller's A is
    # never that buffer
    A = torch.from_numpy(rng.standard_normal((96, 96)).astype(np.float32))
    A0 = A.clone()
    tsingle.lu_factor(A, v=32, partition=partition)
    assert torch.equal(A, A0)


@pytest.mark.parametrize("partition", [0, 1, 2, 4])
@pytest.mark.parametrize("m,n", SCHEME_SHAPES)
def test_flat_highest_matches_jax(rng, m, n, partition):
    A = rng.standard_normal((m, n)).astype(np.float32)
    Fj, pj = jsingle.lu_factor(jnp.asarray(A), v=32, precision="highest",
                               scheme="flat", partition=partition)
    Ft, pt = tsingle.lu_factor(interop.from_numpy(A), v=32,
                               precision="highest", scheme="flat",
                               partition=partition)
    Ft, pt = interop.factors_to_numpy(Ft, pt)
    Fj, pj = np.asarray(Fj), np.asarray(pj)
    assert Ft.shape == (m, n) and pt.dtype == np.int64
    np.testing.assert_array_equal(pt, pj)
    F64, p64 = tsingle._getrf_flat(torch.from_numpy(A).double(), 32,
                                   "highest", partition)
    np.testing.assert_array_equal(pt, p64.numpy())
    F64 = F64.numpy()
    assert np.abs(Ft - F64).max() / np.abs(F64).max() <= 1e-5
    assert np.abs(Ft - Fj).max() / np.abs(Fj).max() <= 2e-5
    assert validation.lu_residual_dense(A, Ft, pt) <= GATE


@pytest.mark.parametrize("m,n", SCHEME_SHAPES)
def test_recursive_highest_matches_jax(rng, m, n):
    A = rng.standard_normal((m, n)).astype(np.float32)
    Fj, pj = jsingle.lu_factor(jnp.asarray(A), v=32, precision="highest",
                               scheme="recursive")
    Ft, pt = tsingle.lu_factor(interop.from_numpy(A), v=32,
                               precision="highest", scheme="recursive")
    Ft, pt = interop.factors_to_numpy(Ft, pt)
    Fj, pj = np.asarray(Fj), np.asarray(pj)
    np.testing.assert_array_equal(pt, pj)
    assert np.abs(Ft - Fj).max() / np.abs(Fj).max() <= 2e-5
    assert validation.lu_residual_dense(A, Ft, pt) <= GATE


def test_flat_high_matches_jax_through_pallas_k3(rng, monkeypatch):
    import functools

    import jax

    import conflux_tpu.ops.pallas_gemm as pg

    n, v = 1024, 512
    A = (5.0 + rng.random((n, n))).astype(np.float32)

    def mode_ok(R, mode, c0, nn):     # shape checks only, no backend check
        return (mode in ("high", "bf16", "bf16out") and R.shape[0] % 512 == 0
                and c0 % 512 == 0 and (nn - c0) % 512 == 0)

    calls = []
    real_k3 = pg.schur_update_pallas

    def k3(*args, **kw):
        calls.append(args[3])
        return real_k3(*args, **kw)

    monkeypatch.setattr(jsingle, "_pallas_mode_ok", mode_ok)
    monkeypatch.setattr(pg, "schur_update_pallas", k3)
    monkeypatch.setattr(pg.pl, "pallas_call",
                        functools.partial(pg.pl.pallas_call, interpret=True))
    jax.clear_caches()
    try:
        Fj, pj = jax.jit(lambda a: jsingle._getrf_flat(a, v, "high"))(
            jnp.asarray(A))
        Fj, pj = np.asarray(Fj), np.asarray(pj)
    finally:
        jax.clear_caches()
    assert calls == [v]               # one fused update, at c0 = v
    Ft, pt = tsingle.lu_factor(interop.from_numpy(A), v=v, precision="high",
                               scheme="flat")
    Ft, pt = interop.factors_to_numpy(Ft, pt)
    res_j = jvalidation.lu_residual_dense(A, Fj, pj)
    res_t = validation.lu_residual_dense(A, Ft, pt)
    print(f"flat 'high' n={n} v={v}: perm agreement {np.mean(pt == pj):.3f}, "
          f"residual jax (Pallas K3) {res_j:.2e} port {res_t:.2e}")
    assert res_j < 1e-8 and res_t < 1e-8
    assert np.array_equal(np.sort(pt), np.arange(n))


@pytest.mark.parametrize("scheme,partition", [("flat", 1), ("flat", 0),
                                              ("flat", 2), ("recursive", 1)])
def test_other_schemes_leave_input_unchanged(rng, scheme, partition):
    # flat updates one copy of A in place; recursive builds new tensors
    A = torch.from_numpy(rng.standard_normal((96, 64)).astype(np.float32))
    A0 = A.clone()
    F, perm = tsingle.lu_factor(A, v=32, scheme=scheme, partition=partition)
    assert torch.equal(A, A0)
    assert validation.lu_residual_dense(A0, F, perm) <= GATE


def test_lu_and_lu_residual_match_jax(rng):
    n = 96
    A = rng.standard_normal((n, n)).astype(np.float32)
    L, U, perm = tsingle.lu(torch.from_numpy(A), v=32)
    np.testing.assert_allclose((L @ U).numpy(), A[perm.numpy()], atol=1e-4)
    F, perm = tsingle.lu_factor(torch.from_numpy(A), v=32)
    res_t = float(tsingle.lu_residual(torch.from_numpy(A), F, perm))
    res_j = float(jsingle.lu_residual(jnp.asarray(A), jnp.asarray(F.numpy()),
                                      jnp.asarray(perm.numpy())))
    # fp32 reconstructions of one factor: at a ~5e-9 residual their own
    # rounding is of the same size, so both must track the float64 value
    dense = validation.lu_residual_dense(A, F.numpy(), perm.numpy())
    assert res_t <= GATE
    for res in (res_t, res_j):
        assert 0.5 * dense <= res <= 2 * dense, (res, dense)


@pytest.mark.parametrize("m,n,block", [(128, 128, 48), (160, 96, 4096)])
def test_residual_gates_match_jax(rng, m, n, block):
    A = rng.standard_normal((m, n)).astype(np.float32)
    F, perm = tsingle.lu_factor(torch.from_numpy(A), v=32)
    Fn, pn = interop.factors_to_numpy(F, perm)
    dense = validation.lu_residual_dense(A, Fn, pn)
    assert dense == jvalidation.lu_residual_dense(A, Fn, pn)
    blocked = validation.lu_residual_blocked(torch.from_numpy(A), F, perm,
                                             block=block)
    jblocked = jvalidation.lu_residual_blocked(A, Fn, pn, block=block)
    # fp32 reconstructions track the float64 value to their own rounding
    assert blocked <= GATE
    for res in (blocked, jblocked):
        assert 0.5 * dense <= res <= 2 * dense, (res, dense)
    assert validation.growth_factor(torch.from_numpy(A), F) == pytest.approx(
        jvalidation.growth_factor(A, Fn), rel=1e-6)


def test_interop_round_trip(rng):
    A = rng.standard_normal((8, 8))
    t = interop.from_numpy(A)
    assert t.dtype == torch.float32 and t.device.type == "cpu"
    F, perm = interop.factors_to_numpy(t, torch.arange(8, dtype=torch.int32))
    assert F.dtype == np.float32 and perm.dtype == np.int64
    np.testing.assert_array_equal(F, A.astype(np.float32))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float64,
                                   torch.complex64])
def test_lu_factor_rejects_unported_dtypes(dtype):
    with pytest.raises(ConfluxError, match="ROADMAP item 7") as e:
        tsingle.lu_factor(torch.eye(8, dtype=dtype))
    assert e.value.code == ErrorCode.INVALID_TYPE


@pytest.mark.parametrize("kw", [{"compaction": "split"},
                                {"compaction": "swap"}])
def test_lu_factor_rejects_unported_options(kw):
    with pytest.raises(ConfluxError, match="ROADMAP item 6"):
        tsingle.lu_factor(torch.eye(8), **kw)


def test_lu_factor_rejects_unknown_scheme():
    with pytest.raises(ConfluxError, match="unknown scheme") as e:
        tsingle.lu_factor(torch.eye(8), scheme="tiled")
    assert e.value.code == ErrorCode.INVALID_SHAPE


def test_lu_factor_rejects_wide_input():
    with pytest.raises(ConfluxError) as e:
        tsingle.lu_factor(torch.ones(4, 8))
    assert e.value.code == ErrorCode.INVALID_SHAPE


def test_lazy_package_api():
    assert conflux_tpu_torch.lu_factor is tsingle.lu_factor
    assert conflux_tpu_torch.lu_residual_blocked is \
        validation.lu_residual_blocked
    with pytest.raises(AttributeError):
        conflux_tpu_torch.not_a_name


def test_timing_refuses_to_time_without_a_card():
    from conflux_tpu_torch import timing

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        timing.timed_run(lambda: None)


def test_port_never_imports_jax():
    # every module of the port, imported in a fresh interpreter: no jax,
    # and no kernel built at import time
    code = """
import importlib, pkgutil, sys
import conflux_tpu_torch
names = [m.name for m in pkgutil.walk_packages(conflux_tpu_torch.__path__,
                                               "conflux_tpu_torch.")]
for name in names:
    importlib.import_module(name)
assert "conflux_tpu_torch.lu.single" in names, names
assert "conflux_tpu_torch.ops.cuda_panel" in names, names
assert "conflux_tpu_torch.ops.cuda_gemm" in names, names
assert "conflux_tpu_torch.cholesky.single" in names, names
assert "conflux_tpu_torch.solve" in names, names
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "conflux_tpu.")))
assert not bad, bad
from conflux_tpu_torch.ops import _build, cuda_gemm, cuda_panel
assert cuda_panel._lib is None and cuda_gemm._lib is None
assert not _build._LOADED
"""
    subprocess.run([sys.executable, "-c", code], check=True)
