"""Single-device LU with partial pivoting: crout, flat and recursive.

PyTorch counterpart of `conflux_tpu/lu/single.py`. Three schemes:

  * crout (left-looking; 'auto' from `CROUT_FROM_M` rows on): each step
    updates its panel ONCE by one big-K matrix product against all
    previous factors, selects its pivots in the panel (ops/panel.py, K1
    on the card), and finishes the winners' full factor row at once;
    nothing else is touched. The live rows then compact into a fresh,
    smaller working buffer.
  * flat (right-looking): each step factors its panel and updates the
    whole trailing region in place by one fused `R[:, c0:] -= M @ U12`
    (ops/gemm.schur_update, K3 on the card); finished rows leave as bands
    into the factor and the live rows compact, every `partition` steps.
  * recursive ('auto' below `CROUT_FROM_M` rows): balanced panel
    splitting with solve_triangular TRSMs; its leaves select pivots
    in 64-wide K1 blocks, its Schur products are library calls
    (ops/tri.schur_dot).

crout's one step loop keeps its live rows contiguous by one of three
compactions: 'gather' (the default: re-gather the live rows into a fresh
buffer), 'split' (the raw matrix never moves; only the multipliers
compact) and 'swap' (the live rows stay a prefix of one full-size buffer,
refilled by a w-row push-up each step). On the card every compaction runs
its big-K products in 'high' and 'bf16' through K2 (ops/gemm.sub_dot),
which beats the library's bf16 passes there ('gather' keeps `schur_dot`
in 'bf16out', whose product the JAX package rounds to bf16); 'split' and
'swap' also run their row gathers through K6 and swap's push-up through
K5 (ops/scatter), where 'gather' keeps torch indexing.

Pivoting lives in the v-wide panel only (masked argmax) and creates no
data-dependent shape, so the step loops never wait for the device.

Dtypes, as in the JAX package: float32; float64 end to end, in every
scheme (its panels run K1 in double on the card, its products IEEE f64 in
'highest' and 'high', one bf16 pass in 'bf16');
and bfloat16 STORAGE in crout (every compaction) and flat: the working
buffer and the factor are bf16, while panels, pivot selection, TRSMs and
every reduction run in f32 and the trailing products accumulate in f32
and round once into the buffer ('bf16' big-K products on bf16 operands,
K2's bf16-operand entry on the card; flat's 'bf16out' update, K3). A
bf16 input with any other scheme runs crout. Complex inputs go to
`lu.csingle.clu_factor`.
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
    trsm_left_lower_unit_into,
    trsm_right_upper,
    unit_lower,
    upper,
)
from conflux_tpu_torch.precision import ieee_fp32
from conflux_tpu_torch.profiler import span

_BF16 = torch.bfloat16


def compute_dtype(dt):
    """Panel-math dtype: f32 for bf16 storage, otherwise the storage
    dtype (f32 or f64)."""
    return torch.float32 if dt == _BF16 else dt


def _partition_now(dead: int, v: int, k: int, w: int, n: int,
                   partition: int) -> bool:
    """Static compaction predicate: compact when `partition` steps' worth of
    rows have died (1: every step; 0/None: only at the very end)."""
    return bool(partition) and dead >= partition * v or k + w >= n


def _live_rows(avail: torch.Tensor, live: int) -> torch.Tensor:
    """The `live` rows where `avail` holds, ascending, without a host
    sync: dead rows sort last."""
    m_r = avail.shape[0]
    rows = torch.arange(m_r, device=avail.device)
    return torch.sort(torch.where(avail, rows, m_r)).values[:live]


def _product_mode(precision: str, dtype: torch.dtype,
                  compaction: str = "") -> str:
    """The mode of a driver's big-K products: 'bf16' on bf16 storage, else
    `precision`, where 'bf16out' on a float32 or float64 working buffer is
    the one 'bf16' pass, rounded only into the buffer's own type (K2's or
    K3's 'bf16' on the card). Crout's 'gather' alone keeps 'bf16out' as
    schur_dot's product rounded to bf16, because the JAX package's
    'gather' crout rounds that product to bf16."""
    if dtype == _BF16 or (precision == "bf16out" and compaction != "gather"):
        return "bf16"
    return precision


def trailing_update(R: torch.Tensor, Mgemm: torch.Tensor, U12: torch.Tensor,
                    c0: int, precision: str):
    """The flat step's one trailing update R[:, c0:] -= Mgemm @ U12 in
    place, in `precision`: bf16 storage's one bf16 pass rounded once into R
    ('bf16out', K3 on the card); IEEE fp32 `torch.mm` for 'highest', or
    the f64 product of schur_dot on a float64 R; K3 otherwise, in
    `_product_mode`, as on the TPU."""
    if R.dtype == _BF16:
        schur_update(R, Mgemm, U12, c0, "bf16out")
    elif precision == "highest" or R.dtype == torch.float64:
        R[:, c0:].sub_(schur_dot(Mgemm, U12, precision))
    else:
        schur_update(R, Mgemm, U12, c0, _product_mode(precision, R.dtype))


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

    bf16 storage: R and F are bf16, each panel is upcast to f32, and the
    trailing update is one 'bf16out' pass into R (K3 on the card). A is
    not modified: R starts as one copy of it."""
    m, n = A.shape
    dev = A.device
    cdt = compute_dtype(A.dtype)
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
        panel = R[:, k:k + w].to(cdt)
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
            U12 = trsm_left_lower_unit(unit_lower(lu_top),
                                       R[piv, k + w:].to(cdt),
                                       method="invert")
            Mgemm = torch.where(avail[:, None], M, 0.0)
            if not splice:
                # the pivot rows' strict(L11) rows, so the one update also
                # writes U12 = raw - strict(L11) @ U12 into them. The
                # JAX package forms this by a one-hot product at HIGHEST
                # precision; the index add is that product, exactly.
                Mgemm[piv] += torch.tril(lu_top, -1)
            trailing_update(R, Mgemm, U12, k + w, precision)
        if part_now:
            done = torch.cat(pend) if len(pend) > 1 else pend[0]
            d = done.shape[0]
            F[row0:row0 + d] = R[done]
            if splice:
                F[row0:row0 + w, k + w:] = U12
            perm[row0:row0 + d] = origin[done]
            row0 += d
            if live > 0:
                live_idx = _live_rows(avail, live)
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


def compact_prefix(R: torch.Tensor, idx: torch.Tensor,
                   rows: int) -> torch.Tensor:
    """R[:len(idx)] = R[idx] in place, `rows` rows at a time, and return
    that prefix. idx must be ascending (so idx[i] >= i): each block then
    reads only rows that no earlier block has written, and the card holds
    one block beside R instead of a second R."""
    live = idx.shape[0]
    for r0 in range(0, live, rows):
        r1 = min(r0 + rows, live)
        R[r0:r1] = R.index_select(0, idx[r0:r1])
    return R[:live]


def _getrf_crout(A: torch.Tensor, v: int, precision: str = "highest",
                 partition: int = 1, consume: bool = False,
                 chunk: int = 8192, compaction: str = "gather"):
    """Blocked crout LU with partial pivoting. Per step k (width w):

      * panel update: P = raw[:, k:k+w] - L @ F[:k, k:k+w], one [m_r, k] x
        [k, w] product of the live rows' multipliers L in `_product_mode`
        (`ops/gemm.sub_dot`);
      * masked-argmax panel factorization over the live rows;
      * the winners' full factor row [L_piv | lu_top | U12] lands in F,
        with U12 = L11^{-1} (raw - L_piv @ F[:k, k+w:]) by one product and
        the blocked TRSM;
      * the live rows keep their multipliers and compact (order kept).

    A crout R's trailing columns are never written: they hold raw values
    until their panel or pivot step. The compactions differ in where the
    live rows' multipliers and raw columns are kept and how they compact:

      * 'gather': one working region R holds both, and every `partition`
        steps the live rows re-gather into a fresh R. The panel
        factorization finishes the pivot lanes (merged=False), so the pivot
        rows' panel columns come back as their merged L\\U factor. A is not
        modified, and peak memory is A, F and the shrinking R. With
        `consume`, A is the working region itself: A is overwritten, and
        each compaction moves the live rows into its prefix in place,
        `chunk` rows at a time (`compact_prefix`), so peak memory is A and
        F.
      * 'split': the raw matrix A is never written or moved. `origin`, the
        A row behind each live slot, stays ascending; each panel and the
        pivot rows' trailing raw values are gathers of A through it (K6 on
        the card), and only Lbuf [m - k, k], the live rows' multipliers,
        compacts. Pivot for pivot the same as 'gather' at partition=1:
        every product and panel operand holds the same values in the same
        row order.
      * 'swap': R is one full-size copy of A whose live rows form a PREFIX
        of length m - k (a Python int per step, so every slice is static);
        each step moves the <= w live rows parked in the outgoing tail
        segment into the pivot slots of the kept prefix (`_pushup_pairs`:
        one w-row gather into a fresh buffer, then one w-row scatter, K6
        and K5 on the card, so no row is read after it is overwritten):
        the static-shape form of the reference's first_non_pivot_row
        push-up, instead of re-gathering the whole live region. Row order
        inside the prefix differs from 'gather', so fp-tie pivots may
        legally differ.

    'split' and 'swap' compact every step and refactor the pivot rows
    (merged=True, `factor_panel`): `partition`, `consume` and `chunk` apply
    to 'gather' only. bf16 storage: R, Lbuf and F are bf16; the panel and
    the winners' raw row are upcast to f32, the big-K products run 'bf16'
    on the bf16 operands, and 'gather' keeps merged=True, so lu_top stays
    f32 for the TRSM instead of passing through bf16 R."""
    with span("lu.factor"):
        return _crout_steps(A, v, precision, partition, consume, chunk,
                            compaction)


def _crout_steps(A, v, precision, partition, consume, chunk, compaction):
    """`_getrf_crout`'s step loop, each step tiled by the phase spans
    lu.update (the panel's big-K product), lu.panel (pivots, multipliers),
    lu.solve (the winners' factor row) and lu.compact."""
    m, n = A.shape
    dev = A.device
    bf16s = A.dtype == _BF16
    cdt = compute_dtype(A.dtype)
    mode = _product_mode(precision, A.dtype, compaction)
    gather, split = compaction == "gather", compaction == "split"
    # working region: 'gather' replaces it and never writes it while it is
    # A, 'split' never writes it, 'swap' scatters into its own copy
    R = A.clone() if compaction == "swap" else A
    origin = torch.arange(m, device=dev)
    avail = torch.ones(m, dtype=torch.bool, device=dev)
    Lbuf = None                    # 'split': [m - k, k] multipliers
    F = torch.zeros((m, n), dtype=A.dtype, device=dev)
    perm = torch.zeros(m, dtype=torch.int64, device=dev)
    dead = 0
    for k in range(0, n, v):
        with span("lu.update"):
            w = min(v, n - k)
            m_r = R.shape[0] if gather else m - k
            panel = (gather_rows(R[:, k:k + w], origin) if split
                     else R[:m_r, k:k + w]).to(cdt)
            if k > 0:
                # no name outlives the product: a view kept of R would hold
                # the old R beside the new one at the next compaction
                panel = sub_dot(panel, Lbuf if split else R[:m_r, :k],
                                F[:k, k:k + w], mode)
        with span("lu.panel"):
            if gather:
                piv, _, M, lu = factor_panel_raw(panel, avail, w, block=128,
                                                 merged=bf16s)
                # panel columns: multipliers on live rows, the merged factor
                # on this step's pivot rows (finished lanes; stale under
                # bf16 storage, whose lu_top comes from `lu`), raw values on
                # dead rows
                cols = torch.where(avail[:, None], M, panel)
                avail[piv] = False     # avail is this function's own tensor
                dead += w
            else:
                # every row is live; factor_panel refactors the pivot rows
                # (merged=True) and writes their merged factor into cols
                piv, _, cols = factor_panel(panel, avail[:m_r], w, block=128)
        with span("lu.solve"):
            # the winners' full factor row, each part written into F in
            # place
            if split:
                Lpiv = gather_rows(Lbuf, piv) if k > 0 else None    # [w, k]
            else:
                Rpiv = R[piv] if gather else gather_rows(R, piv)    # [w, n]
                Lpiv = Rpiv[:, :k]
            if gather:
                lu_top = cols[piv] if lu is None else lu            # [w, w]
            else:
                lu_top = gather_rows(cols, piv)
            if k > 0:
                F[k:k + w, :k] = Lpiv
            F[k:k + w, k:k + w] = lu_top
            if k + w < n:
                rhs = (gather_rows(R[:, k + w:], origin[piv]) if split
                       else Rpiv[:, k + w:]).to(cdt)
                if k > 0:
                    rhs = sub_dot(rhs, Lpiv, F[:k, k + w:], mode)
                trsm_left_lower_unit_into(lu_top, rhs, F[k:k + w, k + w:])
        with span("lu.compact"):
            perm[k:k + w] = origin[piv]
            live = m_r - (dead if gather else w)
            if split and live > 0:
                keep = torch.ones(m_r, dtype=torch.bool, device=dev)
                keep[piv] = False
                live_idx = _live_rows(keep, live)
                Mlive = gather_rows(cols, live_idx).to(A.dtype)  # newborn
                Lbuf = (Mlive if Lbuf is None else
                        torch.cat([gather_rows(Lbuf, live_idx), Mlive], 1))
                origin = origin[live_idx]
            elif compaction == "swap":
                R[:m_r, k:k + w] = cols
                if live > 0:       # the last square step keeps no prefix
                    src, dst = _pushup_pairs(piv, live, w)
                    scatter_rows(R, gather_rows(R, src), dst)
                    origin[dst] = origin[src]
            elif (gather and _partition_now(dead, v, k, w, n, partition)
                  and live > 0):
                live_idx = _live_rows(avail, live)
                # gather first, then write the panel columns into the
                # compacted rows: the same rows as writing R first, and R
                # (which may still be the caller's A) is never written
                # unless the caller gave it up (consume)
                R = (compact_prefix(R, live_idx, chunk) if consume
                     else R[live_idx])
                R[:, k:k + w] = cols[live_idx]
                origin = origin[live_idx]
                avail = torch.ones(live, dtype=torch.bool, device=dev)
                dead = 0
            elif gather and live > 0:
                if R is A and not consume:
                    R = A.clone()  # the first write must not reach A
                R[:, k:k + w] = cols
    if m > n:
        # tail: never-pivoted rows hold completed L rows, in the order
        # perm records (the input's, but for 'swap')
        F[n:] = Lbuf if split else R[:m - n]
        perm[n:] = origin[:m - n]
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
    caller chose (`precision.ieee_fp32`). dtype: float32, float64 (f64
    storage, panels and TRSMs; its big products one IEEE f64 product in
    'highest' and 'high', while 'bf16' rounds their f64 operands to bf16,
    one pass with fp32 accumulation, as the JAX package's x64 mode does,
    so the factor has the accuracy of bf16 products) or bfloat16 storage
    (crout and flat, the big products 'bf16' whatever `precision` says;
    any other scheme runs crout); complex inputs raise and point to
    `lu.csingle.clu_factor`.
    scheme: 'crout', 'flat' or 'recursive'; 'auto' runs the scheme that
    `auto_scheme(m)` names (recursive below `CROUT_FROM_M` rows, crout
    from there), except under bf16 storage, which runs crout. partition
    (flat, crout 'gather'): band / compaction cadence in steps (1 = every
    step, 0 = only at the end). compaction (crout only, the scheme 'auto'
    picked included): 'gather', 'split' or 'swap' (see the module
    docstring). A is never modified."""
    m, n = A.shape
    if m < n:
        raise ConfluxError(ErrorCode.INVALID_SHAPE, "lu_factor expects m >= n")
    check_dtype(A, "lu_factor")
    if scheme not in ("auto", "crout", "flat", "recursive"):
        raise ConfluxError(ErrorCode.INVALID_SHAPE,
                           f"unknown scheme {scheme!r}")
    if compaction not in ("gather", "split", "swap"):
        raise ConfluxError(ErrorCode.INVALID_SHAPE,
                           f"unknown compaction {compaction!r}")
    if A.dtype == _BF16 and scheme not in ("flat", "crout"):
        scheme = "crout"            # the bf16-storage default, as in JAX
    elif scheme == "auto":
        scheme = auto_scheme(m)
    if scheme == "flat":
        return _getrf_flat(A, v, precision, partition=partition)
    if scheme == "recursive":
        return _getrf_rec(A, v, precision)
    return _getrf_crout(A, v, precision, partition=partition,
                        compaction=compaction)


# auto_scheme's threshold: crout from this many rows on, recursive below
CROUT_FROM_M = 2048


def auto_scheme(m: int) -> str:
    """The scheme `lu_factor(scheme='auto')` runs on an [m, n] float32 or
    float64 matrix: 'recursive' below CROUT_FROM_M rows, 'crout' from
    there (the JAX package's dispatch, with the card's threshold).

    Measured by experiments/torch_schemes.py on an NVIDIA H100 80GB HBM3
    at 700.00 W (A = 5 + U(0, 1), v = 1536, 'high'; median wall of five
    interleaved runs): crout beat recursive at every swept N, by more
    than half of either one's spread: 24.8 against 53.9 ms at N = 2048,
    138.0 against 252.7 at 8192, 270.4 against 593.5 at 16384 and 667.2
    against 1279.1 at 32768 (recursive's peak 5.3 copies of A, crout's
    4.1). v = 1024 'high' and v = 128 'highest' ranked them alike. So
    crout runs from the smallest swept N; below it the JAX package's
    choice, recursive, stands."""
    return "recursive" if m < CROUT_FROM_M else "crout"


# the dtypes the real factorizations take
DTYPES = (torch.float32, torch.float64, _BF16)


def check_dtype(A: torch.Tensor, entry: str):
    """Raise INVALID_TYPE unless A is a float32, float64 or bfloat16
    tensor: the tensor's device says where the factorization runs, so a
    numpy array is pointed to `interop.from_numpy`, and a complex A to the
    complex entry points."""
    if not isinstance(A, torch.Tensor):
        raise ConfluxError(ErrorCode.INVALID_TYPE,
                           f"{entry} takes a torch.Tensor, not "
                           f"{type(A).__name__}: make one on the device to "
                           "factor on with interop.from_numpy(A, device)")
    if A.dtype in DTYPES:
        return
    hint = (" (complex LU: lu.csingle.clu_factor, lu.cp25d.clu_25d)"
            if A.dtype.is_complex else "")
    raise ConfluxError(ErrorCode.INVALID_TYPE,
                       f"{entry} takes float32, float64 or bfloat16, not "
                       f"{A.dtype}{hint}")


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
    """The reference's correctness gate ||PA - LU||_F / (N ||A||_F) on the
    factors' device (a 0-d tensor), in the factors' dtype: IEEE fp32 for
    float32 and bf16 factors (upcast), f64 for float64, complex for
    complex."""
    n = F.shape[1]
    F = F.to(compute_dtype(F.dtype))
    L, U = _split_factors(F)
    A = torch.as_tensor(A, device=F.device).to(F.dtype)
    R = A[perm] - L @ U
    return torch.linalg.norm(R) / (n * torch.linalg.norm(A))
