"""Parity of the port's stepped drivers (conflux_tpu_torch/lu/stepped.py,
conflux_tpu_torch/cholesky/stepped.py) and its streaming blocked gates
with the JAX reference, on the same numpy inputs: the cases of
tests/test_stepped.py, each run through both packages, on the CPU.

Tolerances (the JAX test's where it states one):
  * flat LU at 'highest': pivots equal to the JAX stepped driver's and to
    both packages' flat lu_factor; F within the JAX test's 1e-3 of the
    JAX stepped F (which recovers the pivot rows' U12 through
    raw - strict(L11) @ U12 and keeps that product's rounding; measured
    ~3e-4) and, since the port splices the exact U12 as its flat scheme
    does, equal to the port's flat F; the dense gate 1e-6;
  * host and device output bit-equal (the same arithmetic; chunk only
    sizes the row blocks that move);
  * crout stepped: bit-equal to the port's crout lu_factor (it runs that
    driver on the consumed buffer), pivots equal to the JAX crout
    stepped's and to a float64 run's; F, as JAX's F, within 3e-5 of
    max|F| of the float64 run (each fp32 run drifts from it by its own
    roundoff: measured up to 2.2e-5 at n = 256, where test_torch_lu.py's
    smaller shapes stay near 1e-5);
  * Cholesky: bit-equal to the port's flat cholesky (the same steps in
    place), within 1e-6 of max|L| of the JAX stepped L (both IEEE fp32,
    summation order apart: tests/test_torch_cholesky.py);
  * bf16 storage: the JAX test's bounds on the residual against the
    bf16 matrix actually factored (flat 1e-4, Cholesky 1e-4, tall crout
    8e-4), and within 2x of JAX's residual: the port's flat 'bf16out'
    update rounds once where the JAX CPU path rounds the product and then
    the sum (tests/test_torch_dtypes.py), so near-tie pivots may differ;
  * the blocked gates: a host factor's residual equal to the same
    factor's as a tensor, and within 1e-8 of the dense float64 gate (the
    JAX test's).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import conflux_tpu.validation as jvalidation
from conflux_tpu.cholesky import cholesky_stepped as jcholesky_stepped
from conflux_tpu.lu import lu_factor as jlu_factor
from conflux_tpu.lu import lu_factor_stepped as jlu_factor_stepped
from conflux_tpu_torch import validation
from conflux_tpu_torch.cholesky import cholesky, cholesky_stepped
from conflux_tpu_torch.errors import ConfluxError, ErrorCode
from conflux_tpu_torch.lu import lu_factor, lu_factor_stepped
from conflux_tpu_torch.lu.single import _getrf_crout

CPU = "cpu"


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


def _spd(rng, n):
    B = rng.random((n, n)).astype(np.float32)
    return (B @ B.T / n + np.eye(n, dtype=np.float32)).astype(np.float32)


def _bf16(A):
    """(the torch bf16 tensor, the bf16 values as a float32 array)."""
    t = torch.from_numpy(A).to(torch.bfloat16)
    return t, t.float().numpy()


def _normwise(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize("n,v", [(192, 32), (256, 64)])
def test_stepped_matches_lu_factor(rng, n, v):
    A = (5.0 + rng.random((n, n))).astype(np.float32)
    Fj, pj = jlu_factor_stepped(A, v=v, out="device")
    _, pf = jlu_factor(jnp.asarray(A), v=v, scheme="flat")
    F, perm = lu_factor_stepped(A, v=v, out="device", device=CPU)
    Ft, pt = lu_factor(torch.from_numpy(A), v=v, scheme="flat")
    assert perm.dtype == torch.int64
    for p in (pj, pf, pt.numpy()):
        np.testing.assert_array_equal(perm.numpy(), np.asarray(p))
    np.testing.assert_allclose(F.numpy(), np.asarray(Fj), atol=1e-3, rtol=0)
    # the port splices the exact U12 as the flat scheme does: its factor
    assert torch.equal(F, Ft)
    assert validation.lu_residual_dense(A, F, perm) < 1e-6


@pytest.mark.parametrize("scheme", ["flat", "crout"])
def test_stepped_host_out_matches_device(rng, scheme):
    n, v = 160, 32
    A = (5.0 + rng.random((n, n))).astype(np.float32)
    Fd, pd = lu_factor_stepped(A, v=v, out="device", chunk=64,
                               scheme=scheme, device=CPU)
    Fh, ph = lu_factor_stepped(A, v=v, out="host", chunk=64, scheme=scheme,
                               device=CPU)
    assert isinstance(Fh, np.ndarray) and isinstance(ph, np.ndarray)
    np.testing.assert_array_equal(pd.numpy(), ph)
    np.testing.assert_array_equal(Fd.numpy(), Fh)
    # chunk sizes only the row blocks that move: the same bits
    Fc, pc = lu_factor_stepped(A, v=v, out="host", chunk=7, scheme=scheme,
                               device=CPU)
    np.testing.assert_array_equal(Fc, Fh)
    np.testing.assert_array_equal(pc, ph)


def test_stepped_tall_and_residual(rng):
    m, n, v = 256, 128, 32
    A = (5.0 + rng.random((m, n))).astype(np.float32)
    F, perm = lu_factor_stepped(A, v=v, out="host", device=CPU)
    _, pj = jlu_factor_stepped(A, v=v, out="host")
    np.testing.assert_array_equal(perm, np.asarray(pj))
    assert sorted(perm.tolist()) == list(range(m))
    r = validation.lu_residual_dense(A, F, perm)
    assert r < 1e-6, r
    # the blocked streaming residual must agree with the dense gate
    rb = validation.lu_residual_blocked(A, F, perm, block=96, device=CPU)
    assert abs(rb - r) < 1e-8, (rb, r)


def test_stepped_bf16_storage(rng):
    n, v = 192, 32
    A = (5.0 + rng.random((n, n))).astype(np.float32)
    At, Ah = _bf16(A)
    F, perm = lu_factor_stepped(At, v=v, out="device", device=CPU)
    assert F.dtype == torch.bfloat16
    r = validation.lu_residual_blocked(Ah, F, perm, block=64)
    assert r < 1e-4, r
    Fj, pj = jlu_factor_stepped(jnp.asarray(A, jnp.bfloat16), v=v,
                                out="device")
    rj = jvalidation.lu_residual_blocked(Ah, Fj, pj, block=64)
    assert r <= 2 * rj, (r, rj)


@pytest.mark.parametrize("kw,shape,dtype,code", [
    ({}, (4, 8), np.float32, ErrorCode.INVALID_SHAPE),
    ({}, (8, 8), np.float64, ErrorCode.INVALID_TYPE),
    ({"scheme": "tiled"}, (8, 8), np.float32, ErrorCode.INVALID_SHAPE),
    ({"out": "disk"}, (8, 8), np.float32, ErrorCode.INVALID_SHAPE),
])
def test_stepped_rejects_bad_inputs(kw, shape, dtype, code):
    with pytest.raises(ConfluxError) as e:
        lu_factor_stepped(np.zeros(shape, dtype), device=CPU, **kw)
    assert e.value.code == code
    # the JAX driver raises for the first two as well
    if not kw:
        from conflux_tpu.errors import ConfluxError as JError

        with pytest.raises(JError):
            jlu_factor_stepped(np.zeros(shape, dtype))


def test_stepped_consumes_a_tensor_on_its_device(rng):
    n, v = 128, 32
    A = (5.0 + rng.random((n, n))).astype(np.float32)
    R = torch.from_numpy(A.copy())
    F, perm = lu_factor_stepped(R, v=v, out="device", device=CPU)
    # factored in place: the caller's tensor holds F in original row order
    assert torch.equal(R[perm], F)
    F2, p2 = lu_factor_stepped(A, v=v, out="device", device=CPU)
    assert torch.equal(F, F2) and torch.equal(perm, p2)


def test_cholesky_stepped_matches_flat(rng):
    n, v = 192, 32
    S = _spd(rng, n)
    L0 = cholesky(torch.from_numpy(S), v=v, scheme="flat")
    L1 = cholesky_stepped(S, v=v, out="device", device=CPU)
    # the flat scheme's steps on the same values: bitwise-equal factors
    assert torch.equal(L0, L1)
    Lh = cholesky_stepped(S, v=v, out="host", chunk=64, device=CPU)
    assert isinstance(Lh, np.ndarray)
    np.testing.assert_array_equal(L1.numpy(), Lh)
    Lj = np.asarray(jcholesky_stepped(S, v=v, out="device"))
    assert _normwise(Lh, Lj) <= 1e-6
    assert validation.cholesky_residual_dense(S, Lh) < 1e-6
    # a tensor on the device is the factor's storage
    R = torch.from_numpy(S.copy())
    L2 = cholesky_stepped(R, v=v, out="device", device=CPU)
    assert L2.data_ptr() == R.data_ptr() and torch.equal(L2, L0)


def test_cholesky_bf16_storage(rng):
    n, v = 192, 32
    S = _spd(rng, n)
    St, Sh = _bf16(S)
    L = cholesky(St, v=v)
    assert L.dtype == torch.bfloat16
    r = validation.cholesky_residual_blocked(Sh, L, block=64)
    assert r < 1e-4, r
    # stepped agrees with the flat kernel in storage mode too
    Ls = cholesky_stepped(St, v=v, out="device", device=CPU)
    assert torch.equal(L, Ls)
    Lj = jcholesky_stepped(jnp.asarray(S, jnp.bfloat16), v=v, out="device")
    rj = jvalidation.cholesky_residual_blocked(Sh, Lj, block=64)
    assert r <= 2 * rj, (r, rj)


@pytest.mark.parametrize("n,block", [(160, 48), (96, 4096)])
def test_cholesky_residual_blocked_matches_dense(rng, n, block):
    S = _spd(rng, n)
    L = cholesky(torch.from_numpy(S), v=32)
    rd = validation.cholesky_residual_dense(S, L)
    rb = validation.cholesky_residual_blocked(S, L.numpy(), block=block,
                                              device=CPU)
    assert abs(rd - rb) < 1e-8, (rd, rb)
    # a host factor gives the same value as the factor as a tensor
    assert rb == validation.cholesky_residual_blocked(
        torch.from_numpy(S), L, block=block)
    rj = jvalidation.cholesky_residual_blocked(S, np.asarray(L), block=block)
    assert abs(rj - rb) < 1e-8, (rj, rb)


@pytest.mark.parametrize("shape,dtype,code", [
    ((4, 8), np.float32, ErrorCode.INVALID_SHAPE),
    ((8, 8), np.float64, ErrorCode.INVALID_TYPE),
])
def test_cholesky_stepped_rejects_bad_inputs(shape, dtype, code):
    from conflux_tpu.errors import ConfluxError as JError

    with pytest.raises(ConfluxError) as e:
        cholesky_stepped(np.zeros(shape, dtype), device=CPU)
    assert e.value.code == code
    with pytest.raises(JError):
        jcholesky_stepped(np.zeros(shape, dtype))


def test_stepped_crout_matches_single_jit_crout(rng):
    n = 256
    A = rng.standard_normal((n, n)).astype(np.float32)
    F1, p1 = lu_factor_stepped(A, v=64, precision="highest", scheme="crout",
                               out="host", device=CPU)
    F2, p2 = lu_factor(torch.from_numpy(A), v=64, precision="highest",
                       scheme="crout")
    np.testing.assert_array_equal(p1, p2.numpy())
    np.testing.assert_array_equal(F1, F2.numpy())
    Fj, pj = jlu_factor_stepped(A, v=64, precision="highest",
                                scheme="crout")
    np.testing.assert_array_equal(p1, np.asarray(pj))
    F64, p64 = _getrf_crout(torch.from_numpy(A).double(), 64, "highest")
    np.testing.assert_array_equal(p1, p64.numpy())
    assert _normwise(F1, F64) <= 3e-5
    assert _normwise(Fj, F64) <= 3e-5


def test_stepped_crout_tall_bf16s(rng):
    m, n = 320, 256
    A = rng.standard_normal((m, n)).astype(np.float32)
    At, Ah = _bf16(A)
    F, perm = lu_factor_stepped(At, v=64, scheme="crout", device=CPU)
    assert F.dtype == torch.bfloat16
    perm = perm.numpy()
    assert len(np.unique(perm)) == m

    def residual(F, perm):
        Fh = np.asarray(F, np.float64)
        L = np.tril(Fh[:, :n], -1) + np.eye(m, n)
        U = np.triu(Fh[:n])
        return np.linalg.norm(Ah.astype(np.float64)[perm] - L @ U) / (
            n * np.linalg.norm(Ah.astype(np.float64)))

    res = residual(F.float().numpy(), perm)
    assert res < 8e-4, res
    Fj, pj = jlu_factor_stepped(jnp.asarray(A, jnp.bfloat16), v=64,
                                scheme="crout")
    resj = residual(np.asarray(jnp.asarray(Fj).astype(jnp.float32)),
                    np.asarray(pj))
    assert res <= 2 * resj, (res, resj)


@pytest.mark.parametrize("m,n,block", [(128, 128, 48), (160, 96, 4096)])
def test_lu_gate_takes_host_factors(rng, m, n, block):
    # the stepped out='host' factor: numpy A, F and perm, streamed through
    # the computing device, give the same value as the same factor held
    # as tensors, and as the JAX gate's within its 1e-8
    A = rng.standard_normal((m, n)).astype(np.float32)
    F, perm = lu_factor(torch.from_numpy(A), v=32)
    host = validation.lu_residual_blocked(A, F.numpy(), perm.numpy(),
                                          block=block, device=CPU)
    assert host == validation.lu_residual_blocked(torch.from_numpy(A), F,
                                                  perm, block=block)
    jblocked = jvalidation.lu_residual_blocked(A, F.numpy(), perm.numpy(),
                                               block=block)
    assert abs(host - jblocked) < 1e-8


def test_gates_take_the_card_for_a_host_factor(rng):
    # a numpy factor is gated on the card unless the caller names the CPU:
    # without a card that raises, and nothing falls back to the CPU
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    A = rng.standard_normal((8, 8)).astype(np.float32)
    with pytest.raises((RuntimeError, AssertionError)):
        validation.lu_residual_blocked(A, A, np.arange(8))
    with pytest.raises((RuntimeError, AssertionError)):
        validation.cholesky_residual_blocked(A, np.tril(A))
    with pytest.raises((RuntimeError, AssertionError)):
        lu_factor_stepped(A)
