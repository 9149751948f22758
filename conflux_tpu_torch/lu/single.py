"""Single-device LU with partial pivoting: crout, flat and recursive.

PyTorch counterpart of `conflux_tpu/lu/single.py`. Three schemes:

  * crout (left-looking, the default): each step updates its panel ONCE
    by one big-K matrix product against all previous factors, selects its
    pivots in the panel (ops/panel.py, K1 on the card), and finishes the
    winners' full factor row at once; nothing else is touched. The live
    rows then compact into a fresh, smaller working buffer.
  * flat (right-looking): each step factors its panel and updates the
    whole trailing region in place by one fused `R[:, c0:] -= M @ U12`
    (ops/gemm.schur_update, K3 on the card); finished rows leave as bands
    into the factor and the live rows compact, every `partition` steps.
  * recursive: balanced panel splitting with solve_triangular TRSMs.

crout keeps its live rows contiguous by one of three compactions:
'gather' (the default: re-gather the live rows into a fresh buffer),
'split' (the raw matrix never moves; only the multipliers compact) and
'swap' (the live rows stay a prefix of one full-size buffer, refilled by a
w-row push-up each step). On the card every compaction runs its big-K
products in 'high' and 'bf16' through K2 (ops/gemm.sub_dot), which beats
the library's bf16 passes there ('gather' keeps `schur_dot` in 'bf16out',
whose product the JAX package rounds to bf16); 'split' and 'swap' also
run their row gathers through K6 and swap's push-up through K5
(ops/scatter), where 'gather' keeps torch indexing.

Pivoting lives in the v-wide panel only (masked argmax) and creates no
data-dependent shape, so the step loops never wait for the device.
"""

from __future__ import annotations

import torch

from conflux_tpu_torch.errors import ConfluxError, ErrorCode
from conflux_tpu_torch.ops.gemm import schur_update, sub_dot
from conflux_tpu_torch.ops.panel import (
    factor_panel,
    factor_panel_raw,
    select_pivots,
)
from conflux_tpu_torch.ops.scatter import gather_rows, scatter_rows
from conflux_tpu_torch.ops.tri import (
    schur_dot,
    trsm_left_lower_unit,
    trsm_right_upper,
    unit_lower,
    upper,
)
from conflux_tpu_torch.precision import ieee_fp32


def _partition_now(dead: int, v: int, k: int, w: int, n: int,
                   partition: int) -> bool:
    """Static compaction predicate: compact when `partition` steps' worth of
    rows have died (1: every step; 0/None: only at the very end)."""
    return bool(partition) and dead >= partition * v or k + w >= n


def _getrf_flat(A: torch.Tensor, v: int, precision: str = "highest",
                partition: int = 1):
    """Blocked right-looking LU with banded row movement. Per step k
    (panel width w):

      * the masked panel factorization selects w pivots among the live
        rows of the working region R (dead rows never win the argmax);
      * the panel-column write stores merged L\\U rows on the pivots and
        multipliers on live rows; dead rows keep their finished values;
      * ONE trailing update `R[:, k+w:] -= Mgemm @ U12` in place, with
        U12 = L11^{-1} R[piv, k+w:]. When this step's pivot rows leave R
        this very step (cadence 1, the default) they contribute zero rows
        and their band gets the exact U12 spliced in; at other cadences
        the pivot rows stay in R and get strict(L11) rows in Mgemm, which
        turns their raw trailing content into U12 in place;
      * every `partition` steps the finished rows leave R as one band,
        copied into F at its static row offset, and the live rows compact
        (order kept) into a fresh, smaller R.

    A is not modified: R starts as one copy of it."""
    m, n = A.shape
    dev = A.device
    R = A.clone()                  # working region, updated in place
    origin = torch.arange(m, device=dev)
    avail = torch.ones(m, dtype=torch.bool, device=dev)
    F = torch.empty((m, n), dtype=A.dtype, device=dev)
    perm = torch.empty(m, dtype=torch.int64, device=dev)
    row0 = 0                       # F's next band row
    dead = 0
    pend = []                      # each step's pivots since the last band
    for k in range(0, n, v):
        w = min(v, n - k)
        m_r = R.shape[0]
        panel = R[:, k:k + w]
        # block=128: wider rank-1 blocks at the full panel heights
        piv, _, M = factor_panel(panel, avail, w, block=128)
        lu_top = M[piv]                                # [w, w] merged factors
        dead += w
        live = m_r - dead
        part_now = _partition_now(dead, v, k, w, n, partition)
        # the band leaves now and holds only this step's pivots: its U12 is
        # spliced in exactly and Mgemm needs no strict(L11) rows
        splice = part_now and not pend and k + w < n
        pend.append(piv)
        R[:, k:k + w] = torch.where(avail[:, None], M, panel)
        avail[piv] = False         # avail is this function's own tensor
        U12 = None
        if k + w < n:
            U12 = trsm_left_lower_unit(unit_lower(lu_top), R[piv, k + w:],
                                       method="invert")
            Mgemm = torch.where(avail[:, None], M, 0.0)
            if not splice:
                # the pivot rows' strict(L11) rows, so the one update also
                # writes U12 = raw - strict(L11) @ U12 into them. The
                # JAX package forms this by a one-hot product at HIGHEST
                # precision; the index add is that product, exactly.
                Mgemm[piv] += torch.tril(lu_top, -1)
            if precision == "highest":
                R[:, k + w:].sub_(torch.mm(Mgemm, U12))     # IEEE fp32
            else:
                # R is float32 here, so 'bf16out' (one pass rounded into
                # R's own type) is the kernel's 'bf16' pass, as on the TPU
                schur_update(R, Mgemm, U12, k + w,
                             "bf16" if precision == "bf16out" else precision)
        if part_now:
            done = torch.cat(pend) if len(pend) > 1 else pend[0]
            d = done.shape[0]
            F[row0:row0 + d] = R[done]
            if splice:
                F[row0:row0 + w, k + w:] = U12
            perm[row0:row0 + d] = origin[done]
            row0 += d
            if live > 0:
                # sorted live rows without a host sync: dead rows sort last
                rows = torch.arange(m_r, device=dev)
                live_idx = torch.sort(torch.where(avail, rows, m_r)).values[
                    :live]
                R = R[live_idx]
                origin = origin[live_idx]
                avail = torch.ones(live, dtype=torch.bool, device=dev)
            dead = 0
            pend = []
    if m > n:
        # tail: never-pivoted rows hold completed L rows, original order
        F[row0:] = R
        perm[row0:] = origin
    return F, perm


def _getrf_crout(A: torch.Tensor, v: int, precision: str = "highest",
                 partition: int = 1):
    """Blocked crout LU with partial pivoting and 'gather' compaction.
    Per step k (width w):

      * panel update: P = R[:, k:k+w] - R[:, :k] @ F[:k, k:k+w], one
        [m_r, k] x [k, w] product in `precision` (`ops/gemm.sub_dot`);
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
            panel = sub_dot(panel, R[:, :k], F[:k, k:k + w], precision)
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
                rhs = sub_dot(rhs, Rpiv[:, :k], F[:k, k + w:], precision)
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


def _getrf_crout_split(A: torch.Tensor, v: int, precision: str = "highest"):
    """Crout LU with 'split' compaction. A crout R's trailing columns are
    never written (they hold raw values until their panel or pivot step),
    so the raw matrix T = A stays where it is, never written or moved, and
    only the live rows' multipliers compact:

      * origin [m_live]: the T row behind each live slot (ascending);
      * Lbuf [m_live, k]: the live rows' multiplier columns, compacted
        every step (the only state that moves);
      * each panel is one [m_live, w] gather of T's column slice, updated
        by one big-K product against Lbuf; the pivot rows' trailing raw
        values are one [w, n-k-w] gather of T.

    Pivot for pivot the same as 'gather' at partition=1: every product and
    panel operand holds the same values in the same row order. `partition`
    does not apply (Lbuf compacts every step)."""
    m, n = A.shape
    dev = A.device
    # R is float32 here, so 'bf16out' is K2's 'bf16' pass, as on the flat
    # path
    mode = "bf16" if precision == "bf16out" else precision
    T = A
    origin = torch.arange(m, device=dev)
    everyone = torch.ones(m, dtype=torch.bool, device=dev)
    Lbuf = None                    # [m_live, k] multipliers
    F = torch.zeros((m, n), dtype=A.dtype, device=dev)
    perm = torch.zeros(m, dtype=torch.int64, device=dev)
    for k in range(0, n, v):
        w = min(v, n - k)
        m_live = m - k
        panel = gather_rows(T[:, k:k + w], origin)             # [m_live, w]
        if k > 0:
            panel = sub_dot(panel, Lbuf, F[:k, k:k + w], mode)
        piv, _, M = factor_panel(panel, everyone[:m_live], w, block=128)
        lu_top = gather_rows(M, piv)                           # [w, w]
        F[k:k + w, k:k + w] = lu_top
        if k > 0:
            Lpiv = gather_rows(Lbuf, piv)                      # [w, k]
            F[k:k + w, :k] = Lpiv
        if k + w < n:
            rhs = gather_rows(T[:, k + w:], origin[piv])       # [w, n-k-w]
            if k > 0:
                rhs = sub_dot(rhs, Lpiv, F[:k, k + w:], mode)
            F[k:k + w, k + w:] = trsm_left_lower_unit(
                unit_lower(lu_top), rhs, method="invert")
        perm[k:k + w] = origin[piv]
        if m_live > w:
            # sorted live rows without a host sync: pivot rows sort last
            keep = torch.ones(m_live, dtype=torch.bool, device=dev)
            keep[piv] = False
            rows = torch.arange(m_live, device=dev)
            live_idx = torch.sort(torch.where(keep, rows, m_live)).values[
                :m_live - w]
            Mlive = gather_rows(M, live_idx)                   # newborn
            Lbuf = (Mlive if Lbuf is None else
                    torch.cat([gather_rows(Lbuf, live_idx), Mlive], dim=1))
            origin = origin[live_idx]
    if m > n:
        # tail: never-pivoted rows hold completed L rows (all n multiplier
        # columns live in Lbuf), original relative order
        F[n:] = Lbuf
        perm[n:] = origin
    return F, perm


def _pushup_pairs(piv: torch.Tensor, m_live2: int, w: int):
    """(src, dst) rows of one push-up of the 'swap' compaction: the tail
    segment [m_live2, m_live2 + w) leaves the live prefix, and its
    non-pivot (still live) rows move into the pivot slots vacated inside
    the kept prefix [0, m_live2). The counts match (w tail positions =
    pivots in the tail + movers; w pivots = pivots in the tail + slots in
    the prefix), and both lists are ascending, so the real pairs line up
    position by position, as in the JAX code.

    The JAX code pads both lists with a sentinel and drops the padded
    pairs in its scatter; K5 has no drop. The padded positions, one per
    pivot in the tail, are paired instead with those tail pivot rows as
    self-writes. The rows are dead and outside the kept prefix, so they
    are distinct from every real slot, and dst stays unique without a host
    sync."""
    dev = piv.device
    end = m_live2 + w              # sorts after every row of the segment
    tail = m_live2 + torch.arange(w, device=dev)
    in_piv = (tail[:, None] == piv[None, :]).any(dim=1)
    movers = torch.sort(torch.where(in_piv, end, tail)).values
    slots = torch.sort(torch.where(piv < m_live2, piv, end)).values
    # this step's pivots in the tail, ascending, in the last positions
    tail_piv = torch.sort(torch.where(piv >= m_live2, piv, -1)).values
    return (torch.where(movers < end, movers, tail_piv),
            torch.where(slots < end, slots, tail_piv))


def _getrf_crout_swap(A: torch.Tensor, v: int, precision: str = "highest"):
    """Crout LU with 'swap' (push-up) compaction. R is one full-size
    [m, n] copy of A whose live rows form a PREFIX of length m - k (a
    Python int per step, so every slice is static); each step moves the
    <= w live rows parked in the outgoing tail segment into the pivot
    slots of the kept prefix (`_pushup_pairs`: one w-row gather into a
    fresh buffer, then one w-row scatter, so no row is read after it is
    overwritten): the static-shape form of the reference's
    first_non_pivot_row push-up, instead of re-gathering the whole live
    region. Row order inside the prefix differs from 'gather', so fp-tie
    pivots may legally differ. `partition` does not apply (the frontier
    shrinks every step). A is not modified: the scatter writes R in
    place, and R starts as one copy of A."""
    m, n = A.shape
    dev = A.device
    mode = "bf16" if precision == "bf16out" else precision   # as 'split'
    R = A.clone()
    origin = torch.arange(m, device=dev)
    everyone = torch.ones(m, dtype=torch.bool, device=dev)
    F = torch.zeros((m, n), dtype=A.dtype, device=dev)
    perm = torch.zeros(m, dtype=torch.int64, device=dev)
    for k in range(0, n, v):
        w = min(v, n - k)
        m_live = m - k
        panel = R[:m_live, k:k + w]
        if k > 0:
            panel = sub_dot(panel, R[:m_live, :k], F[:k, k:k + w], mode)
        piv, _, M = factor_panel(panel, everyone[:m_live], w, block=128)
        lu_top = gather_rows(M, piv)                           # [w, w]
        R[:m_live, k:k + w] = M
        # the winners' full factor row [L_piv | lu_top | U12], as 'gather'
        Rpiv = gather_rows(R, piv)                             # [w, n]
        if k > 0:
            F[k:k + w, :k] = Rpiv[:, :k]
        F[k:k + w, k:k + w] = lu_top
        if k + w < n:
            rhs = Rpiv[:, k + w:]
            if k > 0:
                rhs = sub_dot(rhs, Rpiv[:, :k], F[:k, k + w:], mode)
            F[k:k + w, k + w:] = trsm_left_lower_unit(
                unit_lower(lu_top), rhs, method="invert")
        perm[k:k + w] = origin[piv]
        m_live2 = m_live - w
        if m_live2 > 0:            # the last square step keeps no prefix
            src, dst = _pushup_pairs(piv, m_live2, w)
            scatter_rows(R, gather_rows(R, src), dst)
            origin[dst] = origin[src]
    if m > n:
        # the live prefix holds completed L rows; their origin order is
        # not the input order after the swaps, which perm records
        F[n:] = R[:m - n]
        perm[n:] = origin[:m - n]
    return F, perm


def _getrf_base(A: torch.Tensor, n: int):
    """Base case of the recursive scheme: [m, n] tall panel, n <= v.
    Returns (F, perm) with A[perm] = unit_lower(F) @ upper(F) and the n
    pivot rows moved to the top in pivot order."""
    m = A.shape[0]
    dev = A.device
    piv, _, lu_top = select_pivots(A, torch.ones(m, dtype=torch.bool,
                                                 device=dev), n)
    # permutation: pivot rows first (in pivot order), the others in order
    rank = torch.full((m,), n, dtype=torch.int64, device=dev)
    rank[piv] = torch.arange(n, device=dev)
    key = torch.where(rank < n, rank, n + torch.arange(m, device=dev))
    perm = torch.argsort(key)
    Ap = A[perm]
    U = upper(lu_top)
    # multipliers of the non-pivot rows: X U = Ap[n:]. An exactly-zero
    # pivot (structurally singular input) is replaced by 1 for the solve,
    # so the factor stays finite, as LAPACK's getrf skips its scaling
    dU = torch.diagonal(U)
    Usafe = U + torch.diag((dU == 0).to(U.dtype))
    Lbot = trsm_right_upper(Ap[n:], Usafe)
    return torch.cat([lu_top, Lbot], dim=0), perm


def _getrf_rec(A: torch.Tensor, v: int, precision: str = "highest"):
    """Recursive right-looking LU of a tall [m, n] block (m >= n). A is not
    modified: every level builds new tensors."""
    m, n = A.shape
    if n <= v:
        return _getrf_base(A, n)
    n1 = max(v, (n // 2 // v) * v)
    F1, p1 = _getrf_rec(A[:, :n1], v, precision)
    A2 = A[p1, n1:]
    L11 = unit_lower(F1[:n1, :n1])
    U12 = trsm_left_lower_unit(L11, A2[:n1])
    S = A2[n1:] - schur_dot(F1[n1:, :n1], U12, precision)
    F2, p2 = _getrf_rec(S, v, precision)
    L21 = F1[n1:, :n1][p2]
    top = torch.cat([F1[:n1], U12], dim=1)
    bot = torch.cat([L21, F2], dim=1)
    perm = p1[torch.cat([torch.arange(n1, device=A.device), n1 + p2])]
    return torch.cat([top, bot], dim=0), perm


@ieee_fp32()
def lu_factor(A: torch.Tensor, v: int = 128, precision: str = "highest",
              scheme: str = "auto", partition: int = 1,
              compaction: str = "gather"):
    """LU with partial pivoting: returns (F, perm) with
    A[perm] = unit_lower(F) @ upper(F); `perm` (int64) maps factor row to
    original row. precision: 'highest' (IEEE fp32), 'high' (bf16x3) or
    'bf16' (bf16 products with fp32 accumulation) for the big products of
    each step; panels and TRSMs stay IEEE fp32 whatever TF32 setting the
    caller chose (`precision.ieee_fp32`).
    scheme: 'crout', 'flat' or 'recursive'. 'auto' runs crout: the JAX
    package's auto_scheme threshold (recursive below N=16384) was measured
    on a TPU, and the port keeps crout until the card's own numbers say
    otherwise. partition (flat, crout 'gather'): band / compaction cadence
    in steps (1 = every step, 0 = only at the end). compaction (crout
    only): 'gather', 'split' or 'swap' (see the module docstring). A is
    never modified."""
    m, n = A.shape
    if m < n:
        raise ConfluxError(ErrorCode.INVALID_SHAPE, "lu_factor expects m >= n")
    if A.dtype != torch.float32:
        raise ConfluxError(
            ErrorCode.INVALID_TYPE,
            f"{A.dtype}: the PyTorch port factors float32 only so far "
            "(bf16 storage, f64 and complex are ROADMAP item 7)")
    if scheme not in ("auto", "crout", "flat", "recursive"):
        raise ConfluxError(ErrorCode.INVALID_SHAPE,
                           f"unknown scheme {scheme!r}")
    if compaction not in ("gather", "split", "swap"):
        raise ConfluxError(ErrorCode.INVALID_SHAPE,
                           f"unknown compaction {compaction!r}")
    if scheme == "flat":
        return _getrf_flat(A, v, precision, partition=partition)
    if scheme == "recursive":
        return _getrf_rec(A, v, precision)
    if compaction == "split":
        return _getrf_crout_split(A, v, precision)
    if compaction == "swap":
        return _getrf_crout_swap(A, v, precision)
    return _getrf_crout(A, v, precision, partition=partition)


def _split_factors(F: torch.Tensor):
    """Merged [m, n] trapezoid -> (L [m, n] unit-lower, U [n, n] upper)."""
    m, n = F.shape
    L = torch.tril(F, -1) + torch.eye(m, n, dtype=F.dtype, device=F.device)
    U = torch.triu(F[:n])
    return L, U


@ieee_fp32()
def lu(A: torch.Tensor, v: int = 128):
    """Convenience wrapper returning (L, U, perm)."""
    F, perm = lu_factor(A, v)
    L, U = _split_factors(F)
    return L, U, perm


@ieee_fp32()
def lu_residual(A: torch.Tensor, F: torch.Tensor,
                perm: torch.Tensor) -> torch.Tensor:
    """The reference's correctness gate ||PA - LU||_F / (N ||A||_F), in
    IEEE fp32 on the factors' device (a 0-d tensor)."""
    n = F.shape[1]
    L, U = _split_factors(F)
    A = torch.as_tensor(A, device=F.device)
    R = A[perm] - L @ U
    return torch.linalg.norm(R) / (n * torch.linalg.norm(A))
