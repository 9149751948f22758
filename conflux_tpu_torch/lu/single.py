"""Single-device LU with partial pivoting: the crout (left-looking) scheme.

PyTorch counterpart of `conflux_tpu/lu/single.py`, for the scheme that
package runs at its single-chip headline size. Each step updates its
panel ONCE by one big-K matrix product against all previous factors,
selects its pivots in the panel (ops/panel.py, K1 on the card), and
finishes the winners' full factor row at once; nothing else is touched.
The live rows then compact into a fresh, smaller working buffer.

Pivoting lives in the v-wide panel only (masked argmax) and creates no
data-dependent shape, so the step loop never waits for the device.
"""

from __future__ import annotations

import torch

from conflux_tpu_torch.errors import ConfluxError, ErrorCode
from conflux_tpu_torch.ops.panel import factor_panel_raw
from conflux_tpu_torch.ops.tri import (
    schur_dot,
    trsm_left_lower_unit,
    unit_lower,
)


def _partition_now(dead: int, v: int, k: int, w: int, n: int,
                   partition: int) -> bool:
    """Static compaction predicate: compact when `partition` steps' worth of
    rows have died (1: every step; 0/None: only at the very end)."""
    return bool(partition) and dead >= partition * v or k + w >= n


def _getrf_crout(A: torch.Tensor, v: int, precision: str = "highest",
                 partition: int = 1):
    """Blocked crout LU with partial pivoting and 'gather' compaction.
    Per step k (width w):

      * panel update: P = R[:, k:k+w] - R[:, :k] @ F[:k, k:k+w], one
        [m_r, k] x [k, w] product in `precision`;
      * masked-argmax panel factorization over the live rows, finishing
        the pivot lanes (merged=False), so the pivot rows' panel columns
        come back as their merged L\\U factor;
      * the winners' full factor row [L_piv | lu_top | U12] lands in F,
        with U12 = L11^{-1} (raw - L_piv @ F[:k, k+w:]) by one product and
        the blocked TRSM;
      * the live rows' multipliers are written to the panel columns of R,
        and every `partition` steps the live rows compact (order kept).

    A is not modified. Peak memory is A, F and the shrinking R."""
    m, n = A.shape
    dev = A.device
    R = A                          # working region; replaced, never written, while it is A
    origin = torch.arange(m, device=dev)
    avail = torch.ones(m, dtype=torch.bool, device=dev)
    F = torch.zeros((m, n), dtype=A.dtype, device=dev)
    perm = torch.zeros(m, dtype=torch.int64, device=dev)
    dead = 0
    for k in range(0, n, v):
        w = min(v, n - k)
        m_r = R.shape[0]
        panel = R[:, k:k + w]
        if k > 0:
            panel = panel - schur_dot(R[:, :k], F[:k, k:k + w], precision)
        piv, _, M, _ = factor_panel_raw(panel, avail, w, block=128,
                                        merged=False)
        # panel columns: multipliers on live rows, the merged factor on
        # this step's pivot rows (finished lanes), raw values on dead rows
        cols = torch.where(avail[:, None], M, panel)
        avail[piv] = False         # avail is this function's own tensor
        dead += w
        # the winners' full factor row, each part written into F in place
        Rpiv = R[piv]                                  # [w, n] row gather
        lu_top = cols[piv]                             # [w, w] merged rows
        if k > 0:
            F[k:k + w, :k] = Rpiv[:, :k]
        F[k:k + w, k:k + w] = lu_top
        if k + w < n:
            rhs = Rpiv[:, k + w:]
            if k > 0:
                rhs = rhs - schur_dot(Rpiv[:, :k], F[:k, k + w:], precision)
            F[k:k + w, k + w:] = trsm_left_lower_unit(
                unit_lower(lu_top), rhs, method="invert")
        perm[k:k + w] = origin[piv]
        live = m_r - dead
        if _partition_now(dead, v, k, w, n, partition) and live > 0:
            # sorted live rows without a host sync: dead rows sort last
            rows = torch.arange(m_r, device=dev)
            live_idx = torch.sort(torch.where(avail, rows, m_r)).values[:live]
            # gather first, then write the panel columns into the fresh
            # buffer: the same rows as writing R first, and R (which may
            # still be the caller's A) is never written
            R = R[live_idx]
            R[:, k:k + w] = cols[live_idx]
            origin = origin[live_idx]
            avail = torch.ones(live, dtype=torch.bool, device=dev)
            dead = 0
        elif live > 0:
            if R is A:
                R = A.clone()      # the first write must not reach A
            R[:, k:k + w] = cols
    if m > n:
        # tail: never-pivoted rows hold completed L rows, original order
        F[n:] = R
        perm[n:] = origin
    return F, perm


def lu_factor(A: torch.Tensor, v: int = 128, precision: str = "highest",
              scheme: str = "auto", partition: int = 1,
              compaction: str = "gather"):
    """LU with partial pivoting: returns (F, perm) with
    A[perm] = unit_lower(F) @ upper(F); `perm` (int64) maps factor row to
    original row. precision: 'highest' (IEEE fp32), 'high' (bf16x3) or
    'bf16' (bf16 products with fp32 accumulation) for the two big-K
    products of each step; panels and TRSMs stay fp32.
    scheme: 'auto' and 'crout' both run crout. partition: compaction
    cadence in steps (1 = every step, 0 = only at the end)."""
    m, n = A.shape
    if m < n:
        raise ConfluxError(ErrorCode.INVALID_SHAPE, "lu_factor expects m >= n")
    if A.dtype != torch.float32:
        raise ConfluxError(
            ErrorCode.INVALID_TYPE,
            f"{A.dtype}: the PyTorch port factors float32 only so far "
            "(bf16 storage, f64 and complex are ROADMAP item 7)")
    if scheme in ("flat", "recursive"):
        raise ConfluxError(
            ErrorCode.INVALID_SHAPE,
            f"scheme {scheme!r} is not ported yet (ROADMAP item 6)")
    if scheme not in ("auto", "crout"):
        raise ConfluxError(ErrorCode.INVALID_SHAPE,
                           f"unknown scheme {scheme!r}")
    if compaction != "gather":
        raise ConfluxError(
            ErrorCode.INVALID_SHAPE,
            f"compaction {compaction!r} is not ported yet (ROADMAP item 6)")
    return _getrf_crout(A, v, precision, partition=partition)


def _split_factors(F: torch.Tensor):
    """Merged [m, n] trapezoid -> (L [m, n] unit-lower, U [n, n] upper)."""
    m, n = F.shape
    L = torch.tril(F, -1) + torch.eye(m, n, dtype=F.dtype, device=F.device)
    U = torch.triu(F[:n])
    return L, U


def lu(A: torch.Tensor, v: int = 128):
    """Convenience wrapper returning (L, U, perm)."""
    F, perm = lu_factor(A, v)
    L, U = _split_factors(F)
    return L, U, perm


def lu_residual(A: torch.Tensor, F: torch.Tensor,
                perm: torch.Tensor) -> torch.Tensor:
    """The reference's correctness gate ||PA - LU||_F / (N ||A||_F), in
    IEEE fp32 on the factors' device (a 0-d tensor)."""
    n = F.shape[1]
    L, U = _split_factors(F)
    A = torch.as_tensor(A, device=F.device)
    R = A[perm] - L @ U
    return torch.linalg.norm(R) / (n * torch.linalg.norm(A))
