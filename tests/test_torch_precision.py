"""The port's entry points run their fp32 products in IEEE fp32 whatever the
caller set (conflux_tpu_torch/precision.ieee_fp32), as the JAX package pins
Precision.HIGHEST on each product.

  * inside each public entry point both of PyTorch's fp32 matmul knobs
    (CUDA and oneDNN) read "ieee", seen through a patched inner function;
  * after the call returns or raises, the caller's settings read back
    exactly as set, through the legacy API (`allow_tf32`,
    `set_float32_matmul_precision`) and through the newer per-backend one;
  * factors, permutations, solutions and residuals are bit-identical to a
    run with PyTorch's defaults, and with the defaults to the undecorated
    functions.
"""

import numpy as np
import pytest
import torch

from conflux_tpu_torch import solve as tsolve
from conflux_tpu_torch import validation
from conflux_tpu_torch.cholesky import single as csingle
from conflux_tpu_torch.errors import ConfluxError
from conflux_tpu_torch.lu import single as tsingle
from conflux_tpu_torch.precision import ieee_fp32

KNOBS = (torch.backends.cuda.matmul, torch.backends.mkldnn.matmul)
N = 96


def _knobs():
    return tuple(k.fp32_precision for k in KNOBS)


@pytest.fixture(autouse=True)
def _restore_process_state():
    """Every test leaves PyTorch's precision settings as it found them (the
    test files share worker processes)."""
    saved = _knobs()
    yield
    for knob, value in zip(KNOBS, saved):
        knob.fp32_precision = value


def _lu_input(seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal((N, N)).astype(np.float32))


def _spd_input(seed=1):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((N, N))
    return torch.from_numpy((X @ X.T + N * np.eye(N)).astype(np.float32))


def _calls():
    """(name, call, (object, attribute) of a function the call reaches)."""
    A, S = _lu_input(), _spd_input()
    F, perm = tsingle.lu_factor(A, v=32)
    L = csingle.cholesky(S, v=32)
    b = torch.ones(N)
    return [
        ("lu_factor", lambda: tsingle.lu_factor(A, v=32),
         (tsingle, "_getrf_rec")),       # auto_scheme's pick at N
        ("lu", lambda: tsingle.lu(A, v=32), (tsingle, "_split_factors")),
        ("lu_residual", lambda: tsingle.lu_residual(A, F, perm),
         (tsingle, "_split_factors")),
        ("cholesky", lambda: csingle.cholesky(S, v=32),
         (csingle, "_potrf_flat")),
        ("cholesky_residual", lambda: csingle.cholesky_residual(S, L),
         (torch.linalg, "norm")),
        ("lu_solve", lambda: tsolve.lu_solve(F, perm, b),
         (torch.linalg, "solve_triangular")),
        ("cho_solve", lambda: tsolve.cho_solve(L, b),
         (torch.linalg, "solve_triangular")),
        ("lu_residual_blocked",
         lambda: validation.lu_residual_blocked(A, F, perm, block=40),
         (torch, "triu")),
        ("cholesky_residual_blocked",
         lambda: validation.cholesky_residual_blocked(S, L, block=40),
         (torch, "sqrt")),
    ]


NAMES = [name for name, _, _ in _calls()]


@pytest.mark.parametrize("name", NAMES)
def test_entry_point_runs_in_ieee_fp32(monkeypatch, name):
    _, call, (obj, attr) = next(c for c in _calls() if c[0] == name)
    seen = []
    inner = getattr(obj, attr)

    def spy(*args, **kwargs):
        seen.append(_knobs())
        return inner(*args, **kwargs)

    monkeypatch.setattr(obj, attr, spy)
    torch.backends.cuda.matmul.fp32_precision = "tf32"
    torch.backends.mkldnn.matmul.fp32_precision = "bf16"
    call()
    assert seen and set(seen) == {("ieee", "ieee")}
    assert _knobs() == ("tf32", "bf16")


@pytest.mark.parametrize("api", ["legacy", "new"])
@pytest.mark.parametrize("outcome", ["returns", "raises"])
def test_caller_settings_come_back_exactly(api, outcome):
    if api == "legacy":
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.set_float32_matmul_precision("medium")
    else:
        torch.backends.cuda.matmul.fp32_precision = "tf32"
        torch.backends.mkldnn.matmul.fp32_precision = "bf16"
    before = _knobs()
    if outcome == "raises":
        with pytest.raises(ConfluxError):
            tsingle.lu_factor(torch.zeros(4, 8))           # m < n
    else:
        tsingle.lu_factor(_lu_input(), v=32)
    assert _knobs() == before
    if api == "legacy":
        # the legacy reads still work: nothing mixed the two APIs
        assert torch.backends.cuda.matmul.allow_tf32 is True
        assert torch.get_float32_matmul_precision() == "medium"
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")


def test_nested_use_changes_nothing():
    torch.backends.cuda.matmul.fp32_precision = "tf32"
    with ieee_fp32():
        with ieee_fp32():
            assert _knobs() == ("ieee", "ieee")
        assert _knobs() == ("ieee", "ieee")
    assert _knobs()[0] == "tf32"


def _results():
    """Every entry point's outputs at 'highest' on small CPU inputs."""
    A, S = _lu_input(), _spd_input()
    b = torch.from_numpy(np.random.default_rng(2).standard_normal(N)
                         .astype(np.float32))
    out = []
    for scheme, compaction in (("crout", "gather"), ("crout", "split"),
                               ("crout", "swap"), ("flat", "gather"),
                               ("recursive", "gather")):
        F, perm = tsingle.lu_factor(A, v=32, scheme=scheme,
                                    compaction=compaction)
        out += [F, perm, tsingle.lu_residual(A, F, perm),
                torch.tensor(validation.lu_residual_blocked(A, F, perm,
                                                            block=40))]
    out.append(tsolve.lu_solve(F, perm, b))
    L = csingle.cholesky(S, v=32)
    out += [L, csingle.cholesky_residual(S, L), tsolve.cho_solve(L, b),
            torch.tensor(validation.cholesky_residual_blocked(S, L))]
    return out


@pytest.mark.parametrize("api", ["legacy", "new"])
def test_results_are_bit_identical_whatever_the_caller_set(api):
    ref = _results()
    if api == "legacy":
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.set_float32_matmul_precision("medium")
    else:
        torch.backends.cuda.matmul.fp32_precision = "tf32"
        torch.backends.mkldnn.matmul.fp32_precision = "bf16"
    try:
        got = _results()
    finally:
        if api == "legacy":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.set_float32_matmul_precision("highest")
    assert all(torch.equal(r, g) for r, g in zip(ref, got))


def test_defaults_give_the_same_bits_as_the_undecorated_functions():
    A = _lu_input(3)
    F, perm = tsingle.lu_factor(A, v=32, precision="high")
    F0, perm0 = tsingle.lu_factor.__wrapped__(A, v=32, precision="high")
    assert torch.equal(F, F0) and torch.equal(perm, perm0)
    S = _spd_input(4)
    assert torch.equal(csingle.cholesky(S, v=32),
                       csingle.cholesky.__wrapped__(S, v=32))
