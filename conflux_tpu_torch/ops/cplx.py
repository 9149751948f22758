"""Complex products, panel and TRSMs as real arithmetic.

PyTorch counterpart of `conflux_tpu/ops/cplx.py`, the complex
instantiation of the factorization stack (complex64, and complex128 as
the JAX package's x64 mode). Every complex product is formed from real
products of the parts, in the JAX package's decomposition:

  * '4m' (default): (Ar+iAi)(Br+iBi) = (ArBr - AiBi) + i(ArBi + AiBr),
    four real products, one rounding per output component pair;
  * '3m' (the cgemm3m trick): K1 = Ar(Br+Bi), K2 = Bi(Ar+Ai),
    K3 = Br(Ai-Ar), re = K1 - K2, im = K1 + K3, three real products.

`torch.mm` on complex tensors would be cgemm, whose rounding is not that
decomposition's, so the parts are taken as real views
(`torch.view_as_real`) and multiplied as real matrices: IEEE fp32 for
complex64 parts (under the entry points' `precision.ieee_fp32` pin) and
f64 for complex128 parts. Pivot scoring is LAPACK cgetrf's
cabs1(z) = |re| + |im|. The JAX package has no Pallas kernel on this
path (its panel is a per-column loop, "no fused Mosaic variant exists"),
so neither has the port: the panel loop below is plain torch, on the
card or the CPU.
"""

from __future__ import annotations

import torch

# diagonal-block size and outer row-block of the blocked substitution (the
# real TRSMs' `_TRSM_SUB` / `_TRSM_OUTER`)
_SUB = 32
_OUTER = 256


def _parts(z: torch.Tensor):
    """(re, im) real views of a complex matrix."""
    zr = torch.view_as_real(z)
    return zr[..., 0], zr[..., 1]


def cschur_dot(a: torch.Tensor, b: torch.Tensor,
               method: str = "4m") -> torch.Tensor:
    """a @ b for complex a [m, k] and b [k, n] by real products of the
    parts (module docstring); returns a's complex dtype."""
    ar, ai = _parts(a)
    br, bi = _parts(b)
    if method == "3m":
        k1 = torch.mm(ar, br + bi)
        k2 = torch.mm(ar + ai, bi)
        k3 = torch.mm(ai - ar, br)
        return torch.complex(k1 - k2, k1 + k3)
    if method != "4m":
        raise ValueError(f"unknown complex product method {method!r}")
    re = torch.mm(ar, br) - torch.mm(ai, bi)
    im = torch.mm(ar, bi) + torch.mm(ai, br)
    return torch.complex(re, im)


def cabs1(z: torch.Tensor) -> torch.Tensor:
    """LAPACK cgetrf's pivot magnitude |re| + |im| (no square root)."""
    zr, zi = _parts(z)
    return zr.abs() + zi.abs()


def cpanel_factor(panel: torch.Tensor, avail: torch.Tensor, w: int):
    """Masked complex panel factorization with partial pivoting, the
    complex twin of ops.panel.factor_panel: returns (piv [w] i64, ok [w]
    bool, M) where M's live non-pivot rows hold their complex multipliers
    and M[piv] the merged L\\U rows of the winners. Scoring is cabs1, the
    first maximal row wins ties, and an exactly-zero pivot divides by 1.

    One rank-1 elimination per column, in the JAX package's order; the
    update touches only the columns right of j (the JAX loop subtracts
    exact zeros from the others). The loop never waits for the device.
    `panel` and `avail` are not modified."""
    m = panel.shape[0]
    dev = panel.device
    M = panel.clone()
    mask = avail.clone()
    rows = torch.arange(m, device=dev)
    piv = torch.zeros(w, dtype=torch.int64, device=dev)
    ok = torch.zeros(w, dtype=torch.bool, device=dev)
    one = torch.ones((), dtype=panel.dtype, device=dev)
    for j in range(w):
        col = M[:, j].clone()
        score = torch.where(mask, cabs1(col), -torch.inf)
        p = torch.argmax(score)
        onehot = rows == p
        prow = M[p]                               # [w], a copy
        pv = prow[j]
        pv = torch.where(pv == 0, one, pv)
        mult = col / pv
        elim = mask & ~onehot
        multm = torch.where(elim, mult, 0)
        if j + 1 < w:
            M[:, j + 1:] -= multm[:, None] * prow[None, j + 1:]
        M[:, j] = torch.where(elim, mult, col)
        piv[j] = p
        ok[j] = mask[p]
        mask = mask & ~onehot
    return piv, ok, M


def _cinv_unit_lower_small(L: torch.Tensor) -> torch.Tensor:
    """Unit-lower complex inverse by nilpotent squaring (the complex twin
    of ops.tri._inv_unit_lower_small); for triangles of at most _SUB."""
    n = L.shape[0]
    eye = torch.eye(n, dtype=L.dtype, device=L.device)
    M = eye - L
    acc = eye + M
    span = 2
    while span < n:
        M = cschur_dot(M, M)
        acc = acc + cschur_dot(acc, M)
        span *= 2
    return acc


def ctrsm_left_lower_unit(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """X = L^{-1} B with L complex unit lower: the two-level blocked
    forward substitution of the real TRSM, every product through
    cschur_dot; only <= _SUB-wide diagonal blocks are inverted."""
    n = L.shape[0]
    if n <= _SUB:
        return cschur_dot(_cinv_unit_lower_small(L), B)
    # X is written block by block in place; each block is read back only
    # after it is final
    X = torch.zeros_like(B)
    for o0 in range(0, n, _OUTER):
        o1 = min(o0 + _OUTER, n)
        rhs_o = B[o0:o1]
        if o0 > 0:
            rhs_o = rhs_o - cschur_dot(L[o0:o1, :o0], X[:o0])
        for i0 in range(o0, o1, _SUB):
            i1 = min(i0 + _SUB, o1)
            rhs = rhs_o[i0 - o0:i1 - o0]
            if i0 > o0:
                rhs = rhs - cschur_dot(L[i0:i1, o0:i0], X[o0:i0])
            X[i0:i1] = cschur_dot(_cinv_unit_lower_small(L[i0:i1, i0:i1]),
                                  rhs)
    return X


def ctrsm_right_upper(B: torch.Tensor, U: torch.Tensor) -> torch.Tensor:
    """X = B U^{-1} with U complex upper (zero diagonal entries replaced by
    1): the unit-upper part is solved as the transposed left unit-lower
    problem, then the columns are scaled."""
    d = torch.diagonal(U)
    d = torch.where(d == 0, torch.ones_like(d), d)
    Uu = U / d[:, None]
    Xt = ctrsm_left_lower_unit(Uu.T, B.T)
    return Xt.T / d[None, :]
