"""The port's public surface against the JAX package's, on the CPU.

  * bfloat16 host arrays (`ml_dtypes.bfloat16`, the JAX package's host
    type, which `torch.from_numpy` refuses) cross by their bits:
    `interop.from_numpy` gives the same tensor as rounding the float32
    array, and the stepped drivers (flat and crout LU, Cholesky) factor
    such an array as the JAX drivers do. Tolerances are the bf16 ones of
    tests/test_torch_stepped.py: the residual against the bf16 matrix
    actually factored (flat 1e-4, crout 8e-4, Cholesky 1e-4) and within
    2x of the JAX driver's; and the factor of the host array equals,
    bit for bit, the port's factor of the same values as a bf16 tensor.
  * `lu_factor` and `cholesky` take tensors: a numpy array raises the
    coded INVALID_TYPE that names `interop.from_numpy`.
  * every name a JAX package `__init__` exports, the port's exports too,
    and every public function of `conflux_tpu.lu.single` (`auto_scheme`
    among them), the port's module too;
    `cholesky.p25d.choose_unroll` answers as the JAX shim does; the
    `ops.inv_*` wrappers pass the JAX checks of
    tests/test_single_device.py (the same matrices, atol 1e-3).
"""

import importlib

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import conflux_tpu.validation as jvalidation
from conflux_tpu.cholesky import cholesky_stepped as jcholesky_stepped
from conflux_tpu.lu import lu_factor_stepped as jlu_factor_stepped
from conflux_tpu_torch import interop, validation
from conflux_tpu_torch.cholesky import cholesky, cholesky_stepped
from conflux_tpu_torch.errors import ConfluxError, ErrorCode
from conflux_tpu_torch.lu import lu_factor, lu_factor_stepped

CPU = "cpu"


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


def _spd(rng, n):
    B = rng.random((n, n)).astype(np.float32)
    return (B @ B.T / n + np.eye(n, dtype=np.float32)).astype(np.float32)


def test_from_numpy_takes_a_bf16_host_array(rng):
    A = rng.standard_normal((24, 40)).astype(np.float32)
    Ab = A.astype(ml_dtypes.bfloat16)
    want = torch.from_numpy(A).to(torch.bfloat16)
    got = interop.from_numpy(Ab, device=CPU, dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)
    # the default dtype widens the bf16 values exactly
    assert torch.equal(interop.from_numpy(Ab, device=CPU), want.float())
    # a wider array asked for as bf16 is still rounded by torch
    assert torch.equal(interop.from_numpy(A, device=CPU,
                                          dtype=torch.bfloat16), want)


def _lu_residual(Ah, F, perm):
    m, n = Ah.shape
    Fh = np.asarray(F, np.float64)
    L = np.tril(Fh[:, :n], -1) + np.eye(m, n)
    U = np.triu(Fh[:n])
    A64 = Ah.astype(np.float64)
    return np.linalg.norm(A64[np.asarray(perm)] - L @ U) / (
        n * np.linalg.norm(A64))


@pytest.mark.parametrize("scheme,shape,v,bound", [
    ("flat", (192, 192), 32, 1e-4),
    ("crout", (320, 256), 64, 8e-4),
])
def test_stepped_lu_takes_a_bf16_host_array(rng, scheme, shape, v, bound):
    A = (5.0 + rng.random(shape)).astype(np.float32) if scheme == "flat" \
        else rng.standard_normal(shape).astype(np.float32)
    Ab = A.astype(ml_dtypes.bfloat16)
    Ah = Ab.astype(np.float32)
    F, perm = lu_factor_stepped(Ab, v=v, scheme=scheme, out="device",
                                device=CPU)
    assert F.dtype == torch.bfloat16
    assert sorted(perm.tolist()) == list(range(shape[0]))
    # the same values as a bf16 tensor: the same factor, bit for bit
    Ft, pt = lu_factor_stepped(torch.from_numpy(A).to(torch.bfloat16), v=v,
                               scheme=scheme, out="device", device=CPU)
    assert torch.equal(perm, pt) and torch.equal(F, Ft)
    r = _lu_residual(Ah, F.float().numpy(), perm.numpy())
    assert r < bound, r
    Fj, pj = jlu_factor_stepped(Ab, v=v, scheme=scheme, out="device")
    rj = _lu_residual(Ah, np.asarray(jnp.asarray(Fj).astype(jnp.float32)),
                      pj)
    assert r <= 2 * rj, (r, rj)


def test_cholesky_stepped_takes_a_bf16_host_array(rng):
    n, v = 192, 32
    Sb = _spd(rng, n).astype(ml_dtypes.bfloat16)
    Sh = Sb.astype(np.float32)
    L = cholesky_stepped(Sb, v=v, out="device", device=CPU)
    assert L.dtype == torch.bfloat16
    St = torch.from_numpy(Sh).to(torch.bfloat16)
    assert torch.equal(L, cholesky(St, v=v))
    r = validation.cholesky_residual_blocked(Sh, L, block=64)
    assert r < 1e-4, r
    Lj = jcholesky_stepped(Sb, v=v, out="device")
    rj = jvalidation.cholesky_residual_blocked(Sh, Lj, block=64)
    assert r <= 2 * rj, (r, rj)


@pytest.mark.parametrize("entry", [lu_factor, cholesky],
                         ids=["lu_factor", "cholesky"])
def test_entry_points_refuse_numpy_with_a_code(entry):
    with pytest.raises(ConfluxError, match="interop.from_numpy") as e:
        entry(np.eye(8, dtype=np.float32))
    assert e.value.code == ErrorCode.INVALID_TYPE


@pytest.mark.parametrize("pkg", ["", ".ops", ".lu", ".cholesky"],
                         ids=["top", "ops", "lu", "cholesky"])
def test_exports_include_the_jax_packages(pkg):
    jmod = importlib.import_module("conflux_tpu" + pkg)
    tmod = importlib.import_module("conflux_tpu_torch" + pkg)
    missing = set(jmod.__all__) - set(tmod.__all__)
    assert not missing, missing
    # every exported name resolves (the top level through its lazy hook)
    for name in tmod.__all__:
        assert getattr(tmod, name) is not None, name


@pytest.mark.parametrize("module", ["lu.single"])
def test_module_functions_include_the_jax_modules(module):
    jmod = importlib.import_module("conflux_tpu." + module)
    tmod = importlib.import_module("conflux_tpu_torch." + module)
    public = [name for name, obj in vars(jmod).items()
              if callable(obj) and not name.startswith("_")
              and getattr(obj, "__module__", None) == jmod.__name__]
    missing = [name for name in public
               if not callable(getattr(tmod, name, None))]
    assert "auto_scheme" in public and not missing, missing


@pytest.mark.parametrize("grid,n,v", [
    ((1, 1, 1), 1024, 128), ((2, 2, 1), 2048, 256), ((2, 2, 2), 4096, 256),
    ((1, 2, 4), 8192, 512), ((4, 4, 1), 65536, 512),
])
def test_choose_unroll_matches_jax(grid, n, v):
    from conflux_tpu.cholesky.p25d import choose_unroll as jchoose
    from conflux_tpu.layout import BlockCyclic as JBlockCyclic
    from conflux_tpu_torch.cholesky.p25d import choose_unroll
    from conflux_tpu_torch.layout import BlockCyclic

    class _Grid:      # the descriptor reads the grid's shape alone
        def __init__(self, shape):
            self.Px, self.Py, self.Pz = shape
            self.shape = shape
            self.P = shape[0] * shape[1] * shape[2]

    jd = JBlockCyclic.create(n, n, v, _Grid(grid))
    td = BlockCyclic.create(n, n, v, _Grid(grid))
    for algorithm in ("cholesky", "lu"):
        assert choose_unroll(td, algorithm) == jchoose(jd, algorithm)


def test_inverse_wrappers(rng):
    from conflux_tpu_torch.ops import inv_lower, inv_unit_lower, inv_upper

    # the JAX test's matrices: off-diagonals scaled by 0.1
    n = 80
    L = 0.1 * np.tril(rng.standard_normal((n, n)), -1).astype(np.float32) \
        + 3 * np.eye(n, dtype=np.float32)
    np.testing.assert_allclose(
        inv_lower(torch.from_numpy(L)).numpy() @ L, np.eye(n), atol=1e-3)
    Lu = np.tril(L, -1) + np.eye(n, dtype=np.float32)
    np.testing.assert_allclose(
        inv_unit_lower(torch.from_numpy(Lu)).numpy() @ Lu, np.eye(n),
        atol=1e-3)
    U = L.T.copy()
    np.testing.assert_allclose(
        U @ inv_upper(torch.from_numpy(U)).numpy(), np.eye(n), atol=1e-3)
