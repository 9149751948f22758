"""CPU tests of crout's winners' solve in the form the card runs it
(conflux_tpu_torch/ops/tri.py): `solve_lower_rows`, block rows of
`_LSOLVE_ROWS` with one library product each, and `_diag_solve_plain`, the
plain version of the diagonal kernel csrc/lower_solve.cu (the kernel itself
is tested on the card, tests/test_torch_cuda.py). The triangles are the
winners' merged factors of real panels (`factor_panel_raw`, |l| <= 1).
CPU tensors keep the JAX package's inverse chain in the crout step loop,
bit for bit."""

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from conflux_tpu_torch.lu import single
from conflux_tpu_torch.ops import _build, cuda_lower_solve, tri
from conflux_tpu_torch.ops.panel import factor_panel_raw

_WINNERS = {}


def _winners(n, dtype):
    """(lu, L in float64, kappa_inf(L)) of the n winners of a random
    [2n, n] panel: lu their merged factors as the panel leaves them."""
    if (n, dtype) not in _WINNERS:
        g = torch.Generator().manual_seed(n)
        panel = torch.randn(2 * n, n, generator=g,
                            dtype=torch.float64).to(dtype)
        _, _, _, lu = factor_panel_raw(
            panel, torch.ones(2 * n, dtype=torch.bool), n, block=128)
        L = torch.tril(lu.double(), -1) + torch.eye(n, dtype=torch.float64)
        kappa = float(L.abs().sum(1).max()
                      * torch.linalg.inv(L).abs().sum(1).max())
        _WINNERS[n, dtype] = lu, L, kappa
    return _WINNERS[n, dtype]


def _rhs(n, c, dtype):
    g = torch.Generator().manual_seed(n + c)
    return torch.randn(n, c, generator=g, dtype=torch.float64).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("c", [1, 33, 4096])
@pytest.mark.parametrize("n", [64, 512, 1536])
def test_plain_blocked_solve_matches_float64_solve(n, c, dtype):
    lu, L, kappa = _winners(n, dtype)
    B = _rhs(n, c, dtype)
    X = torch.empty_like(B)
    tri.solve_lower_rows(lu, B.clone(), X)
    ref = torch.linalg.solve_triangular(L, B.double(), upper=False,
                                        unitriangular=True)
    # a triangular solve's forward error is of the order of eps kappa(L)
    # max|B|
    tol = torch.finfo(dtype).eps * kappa * float(B.abs().max())
    assert float((X.double() - ref).abs().max()) <= tol


@pytest.mark.parametrize("layout", ["row-major", "column-major"])
def test_plain_blocked_solve_writes_a_slice_in_place(layout):
    # as in the step loop: X a slice of the factor, lu in either layout
    n, c = 600, 40
    lu, L, kappa = _winners(n, torch.float32)
    lu = lu.contiguous() if layout == "row-major" else lu.T.contiguous().T
    B = _rhs(n, c, torch.float32)
    F = torch.full((n + 8, c + 24), 7.0)
    Bw = B.clone()
    tri.solve_lower_rows(lu, Bw, F[8:, 24:])
    ref = torch.linalg.solve_triangular(L, B.double(), upper=False,
                                        unitriangular=True)
    tol = torch.finfo(torch.float32).eps * kappa * float(B.abs().max())
    assert float((F[8:, 24:].double() - ref).abs().max()) <= tol
    assert bool((F[:8] == 7.0).all()) and bool((F[:, :24] == 7.0).all())
    # the first block's right-hand sides are read, never written
    assert torch.equal(Bw[:tri._LSOLVE_ROWS], B[:tri._LSOLVE_ROWS])


class _Launches(TorchDispatchMode):
    """The device launches a call would make: every aten op that is not
    a view."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not func.is_view:
            self.ops.append(func)
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("n", [64, 512, 1536])
def test_launch_plan_is_at_most_twelve_a_call(n):
    lu, _, _ = _winners(n, torch.float32)
    B = _rhs(n, 4096, torch.float32)
    X = torch.empty_like(B)
    diag = []
    with _Launches() as mode:
        tri.solve_lower_rows(lu, B, X, lambda *blk: diag.append(blk))
    blocks = -(-n // tri._LSOLVE_ROWS)
    assert len(diag) == blocks
    assert mode.ops == [torch.ops.aten.addmm_.default] * (blocks - 1)
    assert len(mode.ops) + len(diag) <= 12
    assert [d[0].shape[0] for d in diag] == [
        min(tri._LSOLVE_ROWS, n - i) for i in range(0, n, tri._LSOLVE_ROWS)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.bfloat16])
@pytest.mark.parametrize("compaction", ["gather", "split", "swap"])
def test_cpu_crout_keeps_the_inverse_chain_bit_for_bit(compaction, dtype,
                                                       monkeypatch):
    g = torch.Generator().manual_seed(5)
    A = (5.0 + torch.rand(384, 384, generator=g)).to(dtype)
    monkeypatch.setattr(_build, "load", lambda name: pytest.fail(
        f"{name} was loaded for CPU tensors"))
    blocked = []
    monkeypatch.setattr(tri, "solve_lower_rows",
                        lambda *a, **k: blocked.append(a))
    F, perm = single.lu_factor(A, v=128, precision="high", scheme="crout",
                               compaction=compaction)

    def chain(lu, B, out):
        # the step loop's solve before the card's blocked solve
        out[...] = tri.trsm_left_lower_unit(tri.unit_lower(lu), B,
                                            method="invert")

    monkeypatch.setattr(single, "trsm_left_lower_unit_into", chain)
    F0, perm0 = single.lu_factor(A, v=128, precision="high",
                                 scheme="crout", compaction=compaction)
    assert not blocked
    assert torch.equal(F, F0) and torch.equal(perm, perm0)


def test_cpu_solve_leaves_its_right_hand_sides():
    lu, L, _ = _winners(512, torch.float32)
    B = _rhs(512, 33, torch.float32)
    Bw, out = B.clone(), torch.empty_like(B)
    tri.trsm_left_lower_unit_into(lu, Bw, out)
    assert torch.equal(Bw, B)
    assert torch.equal(out, tri.trsm_left_lower_unit(
        tri.unit_lower(lu), B, method="invert"))


def test_kernel_wrapper_refuses_cpu_tensors_before_loading(monkeypatch):
    monkeypatch.setattr(_build, "load", lambda name: pytest.fail(
        f"{name} was loaded for CPU tensors"))
    lu, _, _ = _winners(64, torch.float32)
    B = _rhs(64, 8, torch.float32)
    before = cuda_lower_solve.LAUNCHES
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda_lower_solve.solve_diag(lu, B, torch.empty_like(B))
    assert cuda_lower_solve.LAUNCHES == before
