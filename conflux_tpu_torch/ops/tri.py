"""Triangular kernels: blocked TRSMs, triangular inversion, GEMM precision modes.

PyTorch counterpart of `conflux_tpu/ops/tri.py`. Every function here takes
float32 and float64 (and, where the complex layer calls it, complex)
tensors and computes in their dtype. The panel TRSMs are the
stable blocked substitution of the JAX package: only <= `_TRSM_SUB`-wide
diagonal blocks are ever inverted (nilpotent squaring, all matmuls), and
everything else is a GEMM. Every fp32 matrix product here that forms
multipliers or factors is IEEE fp32 when it runs under the package's
entry points: each one pins PyTorch's fp32 matmul precision to "ieee" for
its call (`precision.ieee_fp32`), whatever TF32 setting the caller chose.
"""

from __future__ import annotations

import torch

from conflux_tpu_torch.precision import ieee_fp32

# diagonal-block size: c^32 amplification of a pivot-multiplier triangle
# stays f32-safe; long-K outer row-block of the two-level substitution
_TRSM_SUB = 32
_TRSM_OUTER = 256
# block rows of `solve_lower_rows` on the card, and the dtypes that take
# it. Measured over crout's 21 winners' solves at N = 32768 on an H100
# (w = 1536, device ms in sum): float32 rows 256 30.1, 384 32.0, 512 40.9,
# the inverse chain 37.1; but at 256 the library's split-K products make up
# to 16 kernels a solve, at 384 at most 10. float64 rows 256 52.7, 384 86.1
# against the chain's 39.3 (the kernel's f64 FMAs run at half the fp32
# rate, the chain's products on the f64 tensor cores), so float64 keeps
# the chain
_LSOLVE_ROWS = 384
_LSOLVE_DTYPES = (torch.float32,)


def _mm_f32acc(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """bf16 @ bf16 accumulated and returned in fp32. A plain bf16 matmul
    returns bf16 and rounds the accumulator away. On CUDA the product keeps
    an fp32 result (`out_dtype`); the CPU has no `aten::mm.dtype` kernel,
    so there the halves are upcast first — products of bf16 values are
    exact in fp32, so only the summation order differs."""
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.mm(a.float(), b.float())


def _split_hi_lo(x: torch.Tensor):
    """bf16x3 operand split x ~= hi + lo, both bf16: hi carries the top 8
    mantissa bits, lo the next 8 (conflux_tpu/ops/pallas_gemm._split_hi_lo)."""
    hi = x.to(torch.bfloat16)
    lo = (x - hi.float()).to(torch.bfloat16)
    return hi, lo


def schur_dot(a: torch.Tensor, b: torch.Tensor, mode: str = "highest",
              bt: bool = False) -> torch.Tensor:
    """Trailing-update (Schur complement) matmul with a selectable precision.

    'highest': IEEE fp32. 'high': the explicit bf16x3 split,
    hi@hi + hi@lo + lo@hi accumulated in fp32 (the lo@lo term is dropped,
    as XLA's Precision.HIGH drops it). 'bf16': bf16 operands, fp32
    accumulation and result. 'bf16out': 'bf16' rounded once to bf16.
    On float64 operands 'highest' and 'high' are both one IEEE f64
    product: the JAX package's x64 mode runs on the CPU backend, where
    both precisions are full f64 products (a bf16x3 split would turn f64
    into bf16x3). bt=True contracts b's last dim (a @ b.T)."""
    if bt:
        b = b.T
    if mode == "highest" or (mode == "high" and a.dtype == torch.float64):
        return torch.mm(a, b)
    if mode == "high":
        ah, al = _split_hi_lo(a)
        bh, bl = _split_hi_lo(b)
        out = _mm_f32acc(ah, bh)
        out += _mm_f32acc(ah, bl)
        out += _mm_f32acc(al, bh)
        return out
    if mode in ("bf16", "bf16out"):
        out = _mm_f32acc(a.to(torch.bfloat16), b.to(torch.bfloat16))
        return out.to(torch.bfloat16) if mode == "bf16out" else out
    raise ValueError(f"unknown schur_dot mode {mode!r}")


def unit_lower(lu: torch.Tensor) -> torch.Tensor:
    """Unit lower-triangular factor of merged L\\U, for tall [m, n] and
    wide [n, m] trapezoids (L is [m, min(m, n)])."""
    m, n = lu.shape
    k = min(m, n)
    eye = torch.eye(m, k, dtype=lu.dtype, device=lu.device)
    return torch.tril(lu[:, :k], -1) + eye


def upper(lu: torch.Tensor) -> torch.Tensor:
    """Square [k, k] (k = min(m, n)) upper-triangular factor of merged L\\U."""
    m, n = lu.shape
    k = min(m, n)
    return torch.triu(lu[:k, :k] if m >= n else lu[:, :k])


def _inv_unit_lower_small(L: torch.Tensor) -> torch.Tensor:
    """Unit-lower inverse by nilpotent squaring: with M = I - L strictly
    lower, (I - M)^{-1} = (I+M)(I+M^2)(I+M^4)... — ceil(log2 n) matmuls."""
    n = L.shape[0]
    eye = torch.eye(n, dtype=L.dtype, device=L.device)
    M = eye - L
    acc = eye + M
    span = 2
    while span < n:
        M = M @ M
        acc = acc + acc @ M
        span *= 2
    return acc


def _inv_lower_rec(L: torch.Tensor, unit: bool, base: int = 128) -> torch.Tensor:
    """inv([[A,0],[B,C]]) = [[iA,0],[-iC @ B @ iA, iC]], log-depth
    recursion with all the work in matmuls. Callers whose triangle holds
    pivot multipliers pass base=32: a wider explicit inverse of such a
    triangle loses f32 accuracy."""
    n = L.shape[0]
    if n <= base:
        if unit:
            return _inv_unit_lower_small(L)
        d = torch.diagonal(L)
        d = torch.where(d == 0, torch.ones_like(d), d)
        # L = D Lu  =>  inv(L) = inv(Lu) D^{-1}
        return _inv_unit_lower_small(L / d[:, None]) / d[None, :]
    n1 = n // 2
    iA = _inv_lower_rec(L[:n1, :n1], unit, base)
    iC = _inv_lower_rec(L[n1:, n1:], unit, base)
    out = torch.zeros_like(L)
    out[:n1, :n1] = iA
    out[n1:, n1:] = iC
    out[n1:, :n1] = -(iC @ (L[n1:, :n1] @ iA))
    return out


def inv_lower(L: torch.Tensor) -> torch.Tensor:
    return _inv_lower_rec(L, unit=False)


def inv_unit_lower(L: torch.Tensor) -> torch.Tensor:
    return _inv_lower_rec(L, unit=True)


def inv_upper(U: torch.Tensor) -> torch.Tensor:
    return _inv_lower_rec(U.T, unit=False).T


def _inv_diag_blocks(T: torch.Tensor, transpose: bool) -> torch.Tensor:
    """Inverses of all `_TRSM_SUB`-wide unit-lower diagonal blocks of T as
    one batched nilpotent squaring [nb, s, s]. transpose=True inverts the
    transposed blocks (unit-upper diagonals). A ragged tail block is padded
    with identity (inv(blockdiag(X, I)) top-left == inv(X))."""
    n = T.shape[0]
    s = _TRSM_SUB
    nb = -(-n // s)
    if n % s:
        Tp = torch.eye(nb * s, dtype=T.dtype, device=T.device)
        Tp[:n, :n] = T
    else:
        Tp = T
    # block (i, i) of the [nb, s, nb, s] view is entry [i, :, i, :]
    D = torch.diagonal(Tp.reshape(nb, s, nb, s), dim1=0, dim2=2)  # [s, s, nb]
    D = D.permute(2, 1, 0) if transpose else D.permute(2, 0, 1)
    eye = torch.eye(s, dtype=T.dtype, device=T.device)
    M = eye - D
    acc = eye + M
    span = 2
    while span < s:
        M = torch.matmul(M, M)
        acc = acc + torch.matmul(acc, M)
        span *= 2
    return acc


def _solve_unit_lower_blocked(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """X = L^{-1} B (L unit lower) by two-level blocked forward
    substitution: <= `_TRSM_SUB` diagonal inverses, the long-K solved
    contributions subtracted once per `_TRSM_OUTER` row block."""
    n = L.shape[0]
    if n <= _TRSM_SUB:
        return _inv_unit_lower_small(L) @ B
    inv = _inv_diag_blocks(L, transpose=False)
    # X is written block by block in place; each block is read back only
    # after it is final
    X = torch.empty_like(B)
    for o0 in range(0, n, _TRSM_OUTER):
        o1 = min(o0 + _TRSM_OUTER, n)
        rhs_o = B[o0:o1]
        if o0 > 0:
            rhs_o = rhs_o - L[o0:o1, :o0] @ X[:o0]
        for i0 in range(o0, o1, _TRSM_SUB):
            i1 = min(i0 + _TRSM_SUB, o1)
            rhs = rhs_o[i0 - o0 : i1 - o0]
            if i0 > o0:  # short-K intra-block update
                rhs = rhs - L[i0:i1, o0:i0] @ X[o0:i0]
            X[i0:i1] = inv[i0 // _TRSM_SUB, : i1 - i0, : i1 - i0] @ rhs
    return X


def _diag_solve_plain(lu: torch.Tensor, B: torch.Tensor,
                      X: torch.Tensor) -> None:
    """Plain PyTorch version of `ops/cuda_lower_solve.solve_diag`: X = L^{-1}
    B written into X, L = tril(lu, -1) + I, by forward substitution row by
    row (each row less its multipliers times the rows solved above)."""
    X[0] = B[0]
    for j in range(1, lu.shape[0]):
        X[j] = B[j] - lu[j, :j] @ X[:j]


def solve_lower_rows(lu: torch.Tensor, B: torch.Tensor, X: torch.Tensor,
                     diag=_diag_solve_plain) -> None:
    """X = L^{-1} B written into X, L = tril(lu, -1) + I, by block rows of
    `_LSOLVE_ROWS`: block i first takes the solved rows above it off its
    right-hand sides, B_i -= L[i, :i] X[:i], one library product in place
    in B (whose rows below the first block are overwritten), then
    `diag(L_ii, B_i, X_i)` solves its own triangle (the card's kernel or
    `_diag_solve_plain`). Two launches a block, one for the first."""
    n = lu.shape[0]
    for i0 in range(0, n, _LSOLVE_ROWS):
        i1 = min(i0 + _LSOLVE_ROWS, n)
        if i0:
            B[i0:i1].addmm_(lu[i0:i1, :i0], X[:i0], alpha=-1)
        diag(lu[i0:i1, i0:i1], B[i0:i1], X[i0:i1])


def trsm_left_lower_unit_into(lu: torch.Tensor, B: torch.Tensor,
                              out: torch.Tensor) -> None:
    """out = L^{-1} B with L = tril(lu, -1) + I: crout's winners' solve,
    out a slice of the factor. CUDA tensors of a `_LSOLVE_DTYPES` dtype
    take `solve_lower_rows` with the card's diagonal kernel, which reads lu
    in place, overwrites B and writes X into out where out has B's dtype
    (else into a fresh tensor, which out's dtype takes on assignment);
    every other tensor takes the JAX package's blocked substitution,
    `trsm_left_lower_unit(unit_lower(lu), B, method="invert")`, which
    leaves B as it was. Products in IEEE fp32 (`precision.ieee_fp32`)."""
    if not (lu.is_cuda and B.dtype in _LSOLVE_DTYPES):
        out.copy_(trsm_left_lower_unit(unit_lower(lu), B, method="invert"))
        return
    from conflux_tpu_torch.ops import cuda_lower_solve

    X = out if out.dtype == B.dtype else torch.empty_like(B)
    with ieee_fp32():
        solve_lower_rows(lu, B, X, cuda_lower_solve.solve_diag)
    if X is not out:
        out.copy_(X)


def _solve_right_upper_blocked(B: torch.Tensor, U: torch.Tensor) -> torch.Tensor:
    """X = B U^{-1} (U upper) by two-level blocked substitution over
    left-to-right column blocks."""
    n = U.shape[0]
    d = torch.diagonal(U)
    d = torch.where(d == 0, torch.ones_like(d), d)
    Uu = U / d[:, None]  # unit upper; U = D Uu row-scaled
    inv = _inv_diag_blocks(Uu, transpose=True)
    # X is written block by block in place (see _solve_unit_lower_blocked)
    X = torch.empty_like(B)
    for o0 in range(0, n, _TRSM_OUTER):
        o1 = min(o0 + _TRSM_OUTER, n)
        rhs_o = B[:, o0:o1]
        if o0 > 0:
            rhs_o = rhs_o - X[:, :o0] @ Uu[:o0, o0:o1]
        for j0 in range(o0, o1, _TRSM_SUB):
            j1 = min(j0 + _TRSM_SUB, o1)
            rhs = rhs_o[:, j0 - o0 : j1 - o0]
            if j0 > o0:
                rhs = rhs - X[:, o0:j0] @ Uu[o0:j0, j0:j1]
            inv_jj = inv[j0 // _TRSM_SUB, : j1 - j0, : j1 - j0].T
            X[:, j0:j1] = rhs @ inv_jj
    return X / d[None, :]


def trsm_left_lower_unit(L: torch.Tensor, B: torch.Tensor,
                         method: str = "solve") -> torch.Tensor:
    """X = L^{-1} B with L unit lower. 'invert' is the blocked
    substitution above; 'solve' is torch.linalg.solve_triangular."""
    if method == "invert":
        return _solve_unit_lower_blocked(L, B)
    return torch.linalg.solve_triangular(L, B, upper=False, unitriangular=True)


def trsm_right_upper(B: torch.Tensor, U: torch.Tensor,
                     method: str = "solve") -> torch.Tensor:
    """X = B U^{-1} with U upper."""
    if method == "invert":
        return _solve_right_upper_blocked(B, U)
    return torch.linalg.solve_triangular(U, B, upper=True, left=False)


def trsm_right_lower_t(B: torch.Tensor, L: torch.Tensor,
                       method: str = "solve") -> torch.Tensor:
    """X = B L^{-T} with L lower."""
    if method == "invert":
        return _solve_right_upper_blocked(B, L.T)
    return torch.linalg.solve_triangular(L.T, B, upper=True, left=False)


def potrf_tile(A: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of a square SPD tile. For an SPD tile the
    unpivoted LU is the LDL^T factorization (A = Lu D Lu^T, D = diag(U)),
    so the factor is Lu * sqrt(D), and the elimination runs through the
    forced rank-1 blocks of `ops/panel.lu_nopivot` (K1 on the card).
    Nonpositive diagonal entries (non-SPD input) zero their column."""
    from conflux_tpu_torch.ops.panel import lu_nopivot  # panel imports tri

    M = lu_nopivot(A)
    s = torch.sqrt(torch.clamp(torch.diagonal(M), min=0.0))
    eye = torch.eye(A.shape[0], dtype=A.dtype, device=A.device)
    return (torch.tril(M, -1) + eye) * s[None, :]
