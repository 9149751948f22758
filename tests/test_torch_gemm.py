"""Parity of the PyTorch port's fused trailing update (conflux_tpu_torch/ops/
gemm.py, K3's plain version) with the JAX reference's Pallas kernel
`schur_update_pallas` run in interpret mode, as tests/test_panel.py runs it,
plus the dispatch rules and the per-kernel build hash.

Tolerances, on the [c0, c1) span (the other columns must be bit-identical):
  * 'high' and 'bf16': both sides take the same bf16 operand values (the
    same round-to-nearest-even hi/lo split), form exact products and sum in
    fp32, so they differ only in summation order:
    max|diff| <= 1e-5 * max(|A| @ |B|);
  * 'bf16out': both round their fp32 result once into a bf16 R. Results
    that straddle a rounding boundary differ by one bf16 ulp, and where
    R - A@B nearly cancels the summation-order difference itself can exceed
    the result's tiny ulp, so the gate is one ulp plus the fp32 tolerance.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import conflux_tpu.ops.pallas_gemm as pg
from conflux_tpu_torch.ops import _build, cuda_gemm
from conflux_tpu_torch.ops import gemm as tgemm
from conflux_tpu_torch.ops.tri import schur_dot

TOL = 1e-5   # of max(|A| @ |B|)
# the shapes of tests/test_panel.py::test_schur_update_pallas_interpret
M, K, NC, C0, C1 = 512, 128, 768, 256, 640


def _bf16_ulp(x):
    """Spacing of bfloat16 numbers at each element of x (8 significant
    bits)."""
    _, e = np.frexp(np.asarray(x, np.float32))
    return np.where(x == 0, 2.0 ** -133, np.ldexp(1.0, e - 8))


def _inputs(seed=42, m=M, k=K, nc=NC, c0=C0, c1=C1):
    rng = np.random.default_rng(seed)
    R = rng.standard_normal((m, nc)).astype(np.float32)
    A = rng.standard_normal((m, k)).astype(np.float32)
    B = rng.standard_normal((k, c1 - c0)).astype(np.float32)
    return R, A, B


@pytest.mark.parametrize("mode", ["high", "bf16", "bf16out"])
def test_schur_update_matches_pallas_interpret(monkeypatch, mode):
    R, A, B = _inputs()
    monkeypatch.setattr(pg.pl, "pallas_call",
                        functools.partial(pg.pl.pallas_call, interpret=True))
    Rj = jnp.asarray(R)
    Rt = torch.from_numpy(R.copy())
    if mode == "bf16out":
        Rj = Rj.astype(jnp.bfloat16)
        Rt = Rt.to(torch.bfloat16)
    R0 = Rt.clone()
    ref = pg.schur_update_pallas(Rj, jnp.asarray(A), jnp.asarray(B), C0,
                                 mode, bm=128, bn=128, c1=C1)
    assert ref.dtype == Rj.dtype
    ref = np.asarray(ref.astype(jnp.float32))
    out = tgemm.schur_update(Rt, torch.from_numpy(A), torch.from_numpy(B),
                             C0, mode, C1)
    assert out is Rt and Rt.dtype == R0.dtype          # in place
    got = Rt.float().numpy()
    assert torch.equal(Rt[:, :C0], R0[:, :C0])
    assert torch.equal(Rt[:, C1:], R0[:, C1:])
    np.testing.assert_array_equal(got[:, :C0], ref[:, :C0])
    np.testing.assert_array_equal(got[:, C1:], ref[:, C1:])
    scale = (np.abs(A) @ np.abs(B)).max()
    d = np.abs(got[:, C0:C1] - ref[:, C0:C1])
    if mode == "bf16out":
        ulp = _bf16_ulp(ref[:, C0:C1])
        print(f"bf16out: max {(d / ulp).max():.2f} ulp, "
              f"{int((d > ulp).sum())} elements over 1 ulp")
        assert (d <= ulp + TOL * scale).all()
    else:
        assert d.max() <= TOL * scale, d.max() / scale


def test_schur_update_high_is_f32_faithful():
    # the split keeps ~16 mantissa bits of each operand: far closer to the
    # float64 product than one bf16 pass
    R, A, B = _inputs(seed=3)
    Rt = torch.from_numpy(R.copy())
    tgemm.schur_update(Rt, torch.from_numpy(A), torch.from_numpy(B), C0,
                       "high", C1)
    exact = R[:, C0:C1].astype(np.float64) - A.astype(np.float64) @ B
    scale = (np.abs(A) @ np.abs(B)).max()
    assert np.abs(Rt.numpy()[:, C0:C1] - exact).max() <= 2e-5 * scale


@pytest.mark.parametrize("c1", [None, 700])
def test_schur_update_plain_is_schur_dot_rounded_once(c1):
    # the plain version is the TPU kernel's arithmetic: one fp32 product,
    # one subtraction, one rounding into R's dtype; c1 defaults to R's width
    stop = NC if c1 is None else c1
    R, A, B = _inputs(seed=5, c1=stop)
    Rb = torch.from_numpy(R).to(torch.bfloat16)
    At, Bt = torch.from_numpy(A), torch.from_numpy(B)
    want = (Rb[:, C0:stop].float() - schur_dot(At, Bt, "bf16")).to(
        torch.bfloat16)
    got = tgemm._schur_update_t(Rb.clone(), At, Bt, C0, "bf16out", c1)
    assert torch.equal(got[:, C0:stop], want)
    assert torch.equal(got[:, :C0], Rb[:, :C0])
    assert torch.equal(got[:, stop:], Rb[:, stop:])


def test_schur_update_rejects_what_the_kernel_does_not_take():
    R = torch.zeros(8, 8)
    A = torch.zeros(8, 4)
    B = torch.zeros(4, 8)
    with pytest.raises(ValueError, match="highest"):
        tgemm.schur_update(R, A, B, 0, "highest")
    with pytest.raises(ValueError):
        tgemm.schur_update(R, A, B, 0, "tf32")
    with pytest.raises(TypeError, match="bfloat16"):
        tgemm.schur_update(R, A, B, 0, "bf16out")
    with pytest.raises(TypeError, match="float32"):
        tgemm.schur_update(R.bfloat16(), A, B, 0, "high")
    # the kernel's wrapper refuses CPU tensors and launches nothing
    before = cuda_gemm.LAUNCHES
    with pytest.raises(ValueError, match="CUDA"):
        cuda_gemm.schur_update(R, A, B, 0, "high")
    assert cuda_gemm.LAUNCHES == before


def test_build_digest_covers_only_its_own_source(tmp_path, monkeypatch):
    # editing one kernel's source must not rebuild another kernel
    (tmp_path / "one.cu").write_text("// one\n")
    (tmp_path / "two.cu").write_text("// two\n")
    monkeypatch.setattr(_build, "_CSRC", tmp_path)
    one, two = _build._digest("one"), _build._digest("two")
    assert one != two
    (tmp_path / "two.cu").write_text("// two, edited\n")
    assert _build._digest("one") == one
    assert _build._digest("two") != two
    (tmp_path / "one.cu").write_text("// one, edited\n")
    assert _build._digest("one") != one


def test_build_digest_of_the_package_kernels():
    digests = {_build._digest(n) for n in ("rank1_panel", "schur_update")}
    assert len(digests) == 2
    assert _build._lib_path("schur_update").name.startswith("libschur_update-")
