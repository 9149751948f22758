"""Single-device Cholesky.

PyTorch counterpart of `conflux_tpu/cholesky/single.py`. The flat scheme
is left-looking and updates one copy of A in place: each column panel is
updated by one [m_k, k] x [k, w] product against all previous panels
(in 'high' `ops/gemm.sub_matmul_bigk`, K2 on the card, its B the
transposed view F[k:k+w, :k].T read in place), then factored (a w x w
`potrf_tile`, K1 in forced mode on the card, and a blocked TRSM). The
recursive scheme splits in halves.

Dtypes, as in the JAX package: float32 and float64 in both schemes (f64
throughout: K1 in double on the card, IEEE f64 products), and bfloat16
STORAGE on the flat scheme (a bf16 input with any scheme runs flat): the
buffer and the factor stay bf16 while each column, the tile potrf and the
TRSM run in f32, and the panel update is col - L21 @ L1t in 'bf16' on the
bf16 operands: on the card K2's bf16-operand entry, which reads the
transposed view L1t = F[k:k+w, :k].T in place; on the CPU its plain
version, `col - schur_dot(L21, L1t, "bf16")` bit for bit.
"""

from __future__ import annotations

import torch

from conflux_tpu_torch.errors import ConfluxError, ErrorCode
from conflux_tpu_torch.lu.single import check_dtype, compute_dtype
from conflux_tpu_torch.ops.gemm import sub_matmul_bigk
from conflux_tpu_torch.ops.tri import potrf_tile, schur_dot, trsm_right_lower_t
from conflux_tpu_torch.precision import ieee_fp32
from conflux_tpu_torch.profiler import span


def _potrf_flat(A: torch.Tensor, v: int,
                precision: str = "highest") -> torch.Tensor:
    """Left-looking blocked Cholesky on one copy of A, updated in place
    (A itself is never written). Exactly N^3/3 product FLOPs. bf16
    storage: F is bf16, each column is upcast to f32 and updated by one
    'bf16' product of the bf16 factor columns."""
    return potrf_inplace(A.clone(), v, precision).tril_()


def potrf_inplace(F: torch.Tensor, v: int,
                  precision: str = "highest") -> torch.Tensor:
    """The steps of `_potrf_flat` on F itself: its lower triangle becomes
    the factor, the strict upper triangle keeps stale values (the
    caller's tril clears them). Returns F. The loop is the span
    chol.factor, each step tiled by chol.update (the column's big-K
    product), chol.panel (the tile's factor) and chol.solve (the TRSM and
    the writes into F): `profiler.span`."""
    n = F.shape[0]
    bf16s = F.dtype == torch.bfloat16
    with span("chol.factor"):
        for k in range(0, n, v):
            with span("chol.update"):
                w = min(v, n - k)
                col = F[k:, k:k + w].to(compute_dtype(F.dtype))
                if k > 0:
                    L21, L1t = F[k:, :k], F[k:k + w, :k].T
                    # K2 in 'high' and on bf16 storage's operands (its
                    # bf16 entry beat the library's product and
                    # subtraction over the bf16 path's 21 steps on the
                    # H100); on f32 operands in 'bf16' it ties with the
                    # library's one pass at these shapes
                    # (experiments/torch_kernel_ab.py --steps, --only
                    # k2bf16)
                    if bf16s:
                        col = sub_matmul_bigk(col, L21, L1t, "bf16")
                    elif precision == "high" and F.dtype == torch.float32:
                        col = sub_matmul_bigk(col, L21, L1t, precision)
                    else:
                        col = col - schur_dot(L21, L1t, precision)
            with span("chol.panel"):
                L11 = potrf_tile(col[:w])
            with span("chol.solve"):
                F[k:k + w, k:k + w] = L11
                if k + w < n:
                    F[k + w:, k:k + w] = trsm_right_lower_t(
                        col[w:], L11, method="invert")
    return F


def _potrf_rec(A: torch.Tensor, v: int,
               precision: str = "highest") -> torch.Tensor:
    n = A.shape[0]
    if n <= v:
        return potrf_tile(A)
    n1 = max(v, (n // 2 // v) * v)
    L11 = _potrf_rec(A[:n1, :n1], v, precision)
    L21 = trsm_right_lower_t(A[n1:, :n1], L11)
    S = A[n1:, n1:] - schur_dot(L21, L21.T, precision)
    L22 = _potrf_rec(S, v, precision)
    top = torch.cat([L11, torch.zeros((n1, n - n1), dtype=A.dtype,
                                      device=A.device)], dim=1)
    bot = torch.cat([L21, L22], dim=1)
    return torch.cat([top, bot], dim=0)


@ieee_fp32()
def cholesky(A: torch.Tensor, v: int = 128, precision: str = "highest",
             scheme: str = "flat") -> torch.Tensor:
    """Lower Cholesky factor of an SPD matrix. scheme: 'flat'
    (left-looking, in place on one copy of A) or 'recursive'. precision
    ('highest', 'high', 'bf16') sets the big update products; tiles and
    TRSMs stay fp32. dtype: float32, float64 or bfloat16 storage (flat
    only: a bf16 A runs flat whatever `scheme` says). A is never
    modified."""
    check_dtype(A, "cholesky")
    if A.dim() != 2 or A.shape[0] != A.shape[1]:
        raise ConfluxError(ErrorCode.INVALID_SHAPE,
                           f"cholesky expects a square matrix, got "
                           f"{tuple(A.shape)}")
    if scheme not in ("flat", "recursive"):
        raise ConfluxError(ErrorCode.INVALID_SHAPE,
                           f"unknown scheme {scheme!r}")
    if scheme == "flat" or A.dtype == torch.bfloat16:
        return _potrf_flat(A, v, precision)
    return _potrf_rec(A, v, precision)


@ieee_fp32()
def cholesky_residual(A: torch.Tensor, L: torch.Tensor) -> torch.Tensor:
    """||A - L L^T||_F / (N ||A||_F) on the factor's device (a 0-d
    tensor), in IEEE fp32 for float32 and bf16 factors (upcast), f64 for
    float64."""
    n = L.shape[0]
    L = L.to(compute_dtype(L.dtype))
    A = torch.as_tensor(A, device=L.device).to(L.dtype)
    return torch.linalg.norm(A - L @ L.T) / (n * torch.linalg.norm(A))
