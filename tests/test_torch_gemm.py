"""Parity of the PyTorch port's matrix-product kernels (conflux_tpu_torch/
ops/gemm.py: the plain versions of K3, K2 and K4) with the JAX reference's
Pallas kernels `schur_update_pallas`, `sub_matmul_pallas_bigk` and
`matmul_pallas` run in interpret mode, as tests/test_panel.py runs them,
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
K2 is held to the same gates. K4 sums exact products (fp32 operands in
interpret mode, bf16 operands exactly representable) in fp32:
max|diff| <= 1e-5 * max(|A| @ |B|).
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
    before = cuda_gemm.SCHUR_UPDATE_LAUNCHES
    with pytest.raises(ValueError, match="CUDA"):
        cuda_gemm.schur_update(R, A, B, 0, "high")
    assert cuda_gemm.SCHUR_UPDATE_LAUNCHES == before


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


def test_build_digest_covers_the_headers_a_source_includes(tmp_path,
                                                          monkeypatch):
    # a shared header rebuilds every source that includes it, and only those
    (tmp_path / "tile.cuh").write_text("// tile\n")
    (tmp_path / "other.cuh").write_text("// other\n")
    (tmp_path / "one.cu").write_text('#include "tile.cuh"\n// one\n')
    (tmp_path / "two.cu").write_text("#include <cstdint>\n// two\n")
    monkeypatch.setattr(_build, "_CSRC", tmp_path)
    one, two = _build._digest("one"), _build._digest("two")
    (tmp_path / "other.cuh").write_text("// other, edited\n")
    assert (_build._digest("one"), _build._digest("two")) == (one, two)
    (tmp_path / "tile.cuh").write_text("// tile, edited\n")
    assert _build._digest("one") != one
    assert _build._digest("two") == two


def test_build_digest_covers_headers_included_by_headers(tmp_path,
                                                         monkeypatch):
    # a header reached through another header (wgmma_tile.cuh through
    # wgmma_split.cuh) rebuilds the sources that include the outer one
    (tmp_path / "inner.cuh").write_text("// inner\n")
    (tmp_path / "outer.cuh").write_text('#include "inner.cuh"\n')
    (tmp_path / "one.cu").write_text('#include "outer.cuh"\n// one\n')
    monkeypatch.setattr(_build, "_CSRC", tmp_path)
    one = _build._digest("one")
    (tmp_path / "inner.cuh").write_text("// inner, edited\n")
    assert _build._digest("one") != one


def test_build_digest_of_the_package_kernels():
    names = ("rank1_panel", "schur_update", "bigk_gemm", "row_move")
    digests = {_build._digest(n) for n in names}
    assert len(digests) == len(names)
    assert _build._lib_path("schur_update").name.startswith("libschur_update-")


# K2 against the JAX kernel at a few 128-blocks per axis (its divisibility
# asserts hold there; the port has none)
BM, BK, BN = 384, 256, 256


@pytest.mark.parametrize("mode", ["high", "bf16", "bf16out"])
def test_sub_matmul_bigk_matches_pallas_interpret(monkeypatch, mode):
    rng = np.random.default_rng(7)
    R = rng.standard_normal((BM, BN)).astype(np.float32)
    A = rng.standard_normal((BM, BK)).astype(np.float32)
    B = rng.standard_normal((BK, BN)).astype(np.float32)
    monkeypatch.setattr(pg.pl, "pallas_call",
                        functools.partial(pg.pl.pallas_call, interpret=True))
    Rj = jnp.asarray(R)
    Rt = torch.from_numpy(R.copy())
    if mode == "bf16out":
        Rj = Rj.astype(jnp.bfloat16)
        Rt = Rt.to(torch.bfloat16)
    R0 = Rt.clone()
    ref = pg.sub_matmul_pallas_bigk(Rj, jnp.asarray(A), jnp.asarray(B), mode,
                                    bm=128, bn=128, bk=128)
    assert ref.dtype == Rj.dtype
    ref = np.asarray(ref.astype(jnp.float32))
    out = tgemm.sub_matmul_bigk(Rt, torch.from_numpy(A), torch.from_numpy(B),
                                mode)
    assert out is not Rt and out.dtype == Rt.dtype
    assert torch.equal(Rt, R0)                          # R is read only
    got = out.float().numpy()
    scale = (np.abs(A) @ np.abs(B)).max()
    d = np.abs(got - ref)
    if mode == "bf16out":
        ulp = _bf16_ulp(ref)
        print(f"bf16out: max {(d / ulp).max():.2f} ulp, "
              f"{int((d > ulp).sum())} elements over 1 ulp")
        assert (d <= ulp + TOL * scale).all()
    else:
        assert d.max() <= TOL * scale, d.max() / scale


@pytest.mark.parametrize("shape", [(100, 37, 61), (1, 300, 5)])
def test_sub_matmul_bigk_plain_takes_any_shape_and_stride(shape):
    # no divisibility rule, and operands may be strided column slices
    m, k, n = shape
    rng = np.random.default_rng(m + k)
    big = torch.from_numpy(rng.standard_normal((m + 3, k + n + 9))
                           .astype(np.float32))
    R, A = big[:m, 9:9 + n], big[3:, :k]
    B = torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32))
    want = (R.double() - A.double() @ B.double()).float()
    got = tgemm.sub_matmul_bigk(R, A, B, "high")
    assert got.shape == (m, n) and got.is_contiguous()
    scale = float((A.abs() @ B.abs()).max())
    assert float((got - want).abs().max()) <= 2e-5 * scale


def test_sub_matmul_bigk_plain_is_schur_dot_rounded_once():
    R, A, B = _inputs(seed=9, c0=0, c1=NC)
    Rb = torch.from_numpy(R).to(torch.bfloat16)
    At, Bt = torch.from_numpy(A), torch.from_numpy(B)
    want = (Rb.float() - schur_dot(At, Bt, "bf16")).to(torch.bfloat16)
    assert torch.equal(tgemm._sub_matmul_bigk_t(Rb, At, Bt, "bf16out"), want)


def test_sub_matmul_bigk_rejects_what_the_kernel_does_not_take():
    R = torch.zeros(8, 8)
    A = torch.zeros(8, 4)
    B = torch.zeros(4, 8)
    # the JAX kernel runs 'highest' as 'high'; the port refuses it
    with pytest.raises(ValueError, match="highest"):
        tgemm.sub_matmul_bigk(R, A, B, "highest")
    with pytest.raises(TypeError, match="bfloat16"):
        tgemm.sub_matmul_bigk(R, A, B, "bf16out")
    before = cuda_gemm.SUB_MATMUL_BIGK_LAUNCHES
    with pytest.raises(ValueError, match="CUDA"):
        cuda_gemm.sub_matmul_bigk(R, A, B, "high")
    assert cuda_gemm.SUB_MATMUL_BIGK_LAUNCHES == before


# the bf16 Cholesky's panel update col - L21 @ L1t on bf16 storage's
# operands (m, k, w): a step of N = 160, v = 48 and ragged shapes; L1t is
# the transposed view F[k:k+w, :k].T, L21 = F[k:, :k], col an f32 upcast
BF16_PANELS = [(112, 48, 48), (37, 61, 29), (3, 5, 3), (70, 1, 33)]


@pytest.mark.parametrize("m,k,w", BF16_PANELS)
def test_sub_matmul_bigk_plain_is_the_bf16_cholesky_update(m, k, w):
    """On CPU tensors sub_matmul_bigk is R - schur_dot(A, B, 'bf16') bit
    for bit, also on bf16 operands with B a transposed view: routing the
    bf16 Cholesky's panel update through it moves no CPU result."""
    rng = np.random.default_rng(m * 7 + k)
    F = torch.from_numpy(rng.standard_normal((k + max(m, w), k + w))
                         .astype(np.float32)).to(torch.bfloat16)
    L21, L1t = F[k:k + m, :k], F[k:k + w, :k].T
    assert L1t.stride(0) == 1 and L1t.shape == (k, w)
    col = F[k:k + m, k:k + w].to(torch.float32)
    want = col - schur_dot(L21, L1t, "bf16")
    got = tgemm.sub_matmul_bigk(col, L21, L1t, "bf16")
    assert got.dtype == torch.float32 and torch.equal(got, want)
    assert torch.equal(tgemm._sub_matmul_bigk_t(col, L21, L1t, "bf16"), want)


@pytest.mark.parametrize("case", ["mode", "high", "A dtype", "B dtype",
                                  "R dtype", "A shape", "B shape", "R dim"])
def test_sub_matmul_bigk_bf16_checks_before_any_launch(case):
    """The bf16 entry's argument checks raise on CPU tensors, ahead of its
    device checks and of any library load or launch."""
    bf = torch.bfloat16
    R, A, B = torch.zeros(8, 6), torch.zeros(8, 4, dtype=bf), \
        torch.zeros(4, 6, dtype=bf)
    mode = "bf16"
    want = ValueError
    if case == "mode":
        mode = "bf16x"
    elif case == "high":
        mode = "high"
    elif case == "A dtype":
        A, want = A.float(), TypeError
    elif case == "B dtype":
        B, want = B.half(), TypeError
    elif case == "R dtype":
        R, want = R.to(bf), TypeError        # 'bf16' takes a float32 R
    elif case == "A shape":
        A = torch.zeros(7, 4, dtype=bf)
    elif case == "B shape":
        B = torch.zeros(5, 6, dtype=bf)
    else:
        R = torch.zeros(8, 6, 1)
    before = (cuda_gemm.SUB_MATMUL_BIGK_BF16_LAUNCHES, cuda_gemm._bigk_lib)
    with pytest.raises(want):
        cuda_gemm.sub_matmul_bigk_bf16(R, A, B, mode)
    with pytest.raises(want):
        cuda_gemm.check_bf16_operands(R, A, B, mode)
    assert (cuda_gemm.SUB_MATMUL_BIGK_BF16_LAUNCHES,
            cuda_gemm._bigk_lib) == before
    # well-formed CPU operands are refused for their device, still unlaunched
    with pytest.raises(ValueError, match="CUDA"):
        cuda_gemm.sub_matmul_bigk_bf16(torch.zeros(8, 6), torch.zeros(
            8, 4, dtype=bf), torch.zeros(4, 6, dtype=bf), "bf16")
    assert cuda_gemm.SUB_MATMUL_BIGK_BF16_LAUNCHES == before[0]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matmul_matches_pallas_interpret(monkeypatch, dtype):
    rng = np.random.default_rng(11)
    A = rng.standard_normal((256, 384)).astype(np.float32)
    B = rng.standard_normal((384, 256)).astype(np.float32)
    Aj, Bj = jnp.asarray(A).astype(dtype), jnp.asarray(B).astype(dtype)
    monkeypatch.setattr(pg.pl, "pallas_call",
                        functools.partial(pg.pl.pallas_call, interpret=True))
    ref = np.asarray(pg.matmul_pallas(Aj, Bj, bm=128, bn=128, bk=128))
    tdt = getattr(torch, dtype)
    At = torch.from_numpy(A).to(tdt)
    Bt = torch.from_numpy(B).to(tdt)
    # both sides take the same operand values
    np.testing.assert_array_equal(At.float().numpy(),
                                  np.asarray(Aj.astype(jnp.float32)))
    got = tgemm.matmul(At, Bt)
    assert got.dtype == torch.float32 and got.shape == (256, 256)
    scale = (np.abs(At.float().numpy()) @ np.abs(Bt.float().numpy())).max()
    assert np.abs(got.numpy() - ref).max() <= TOL * scale


def test_matmul_rejects_what_the_kernel_does_not_take():
    a = torch.zeros(8, 4)
    with pytest.raises(TypeError, match="float32"):
        tgemm.matmul(a, torch.zeros(4, 8, dtype=torch.bfloat16))
    with pytest.raises(TypeError):
        tgemm.matmul(a.double(), torch.zeros(4, 8).double())
    with pytest.raises(ValueError, match="shapes"):
        tgemm.matmul(a, torch.zeros(5, 8))
    before = cuda_gemm.MATMUL_LAUNCHES
    with pytest.raises(ValueError, match="CUDA"):
        cuda_gemm.matmul(a, torch.zeros(4, 8))
    assert cuda_gemm.MATMUL_LAUNCHES == before
