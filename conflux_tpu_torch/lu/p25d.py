"""2.5D distributed LU with tournament pivoting (CONFLUX), one process per
rank.

PyTorch counterpart of `conflux_tpu/lu/p25d.py`: the right-looking rank
program `conflux::LU_rep` (conflux_opt.hpp:343-1830) on this rank's
[Ml, Nl] block of the z-partial layout (layout.py), with data moving only
through the named-axis collectives of `comm.Comm`. Per step k:

  step 0  the step's panel column is reduced over 'z' only now (the lazy
          2.5D reduction, conflux_opt.hpp:618-648);
  step 1  the v pivot rows are chosen over 'x': each rank picks v
          candidates from its rows by masked partial pivoting
          (`ops/panel`, K1 on the card at [64, m] blocks of its [mr, v]
          column), then a log-round butterfly of `ppermute`s merges them
          (any Px: `butterfly_pair`'s receive map with masked-psum
          broadcasts for multi-destination sources, conflux_opt.hpp:
          220-336), or one all_gather merge ('gather'); 'full' gathers the
          whole column (exact partial pivoting), 'none' takes the diagonal
          tile (EmptyPivot). The owner column's winners and merged factor
          lu00 are psum-broadcast over 'y';
  steps 2+3  one masked psum over ('x', 'z') delivers the v pivot rows,
          full width, to every rank; the owner row writes them into F;
  steps 4+5  the A10 and A01 TRSMs against U00 and L00;
  step 6  the split-K trailing update: layer pz subtracts its
          l = ceil(v/Pz)-wide slice of L10 @ U01, broadcast over 'y'
          (`_trailing_sub`, K3 on the card in 'high' and 'bf16').

Dead rows stay in place, masked by `active`, until a row rebalance
(`_rebalance_rows`) moves the live ones evenly over 'x' into a smaller
block; F collects the factor rows in pivot order, so the result is the
reference's layout: merged L\\U of P·A in block-cyclic order plus the
global pivot vector (conflux_opt.hpp:497-503).

Variants. The JAX package has 'fori' and 'windowed' versions of the
right-looking program to bound XLA's trace; eager PyTorch has none, so
every name here runs the one program, whose step k slices its exact live
column window, and the names set its row rebalance and update split:
'fori' never rebalances (the JAX fori program's row layout); 'unrolled'
rebalances every `rowpart` steps (default Px); 'lookahead' is 'unrolled'
with each trailing update split so the next panel column is updated and
reduced first; 'windowed' rebalances at each segment start of
`dispatch.segment_bounds(Nt, windows)`.

'crout' is the left-looking rank program (`_local_lu_25d_crout`): no
trailing update; each step's panel column is assembled by one big-K
product against the frozen L columns and the U rows already in F, and
the winners' U12 row is finished by a second, distributed big-K product.

Dtypes, as in the JAX package: float32, float64 (f64 throughout: K1 in
double, IEEE f64 products) and bfloat16 STORAGE in every variant: the
local block, its z-partials and the factor F stay bf16, while the panel
math, pivot selection, TRSMs and every reduction run in f32 (each slice
is upcast before its psum), the right-looking trailing update is one
'bf16out' pass into the bf16 block (K3 where it applies), and the crout
program's big-K products are 'bf16' on the bf16 operands. Collectives
move each tensor in the dtype the JAX program moves it in (comm.py).
"""

from __future__ import annotations

from collections import Counter

import torch

from conflux_tpu_torch.dispatch import normalize_variant, segment_bounds
from conflux_tpu_torch.errors import ConfluxError, ErrorCode
from conflux_tpu_torch.layout import (
    BlockCyclic,
    butterfly_pair,
    distribute,
    local_row_to_global,
    local_tile_to_global,
    undistribute,
)
from conflux_tpu_torch.lu.single import (check_dtype, compute_dtype,
                                         lu_factor)
from conflux_tpu_torch.ops.gemm import schur_update
from conflux_tpu_torch.ops.panel import _lu_select_loop_t, \
    factor_panel_raw, lu_nopivot, select_pivots
from conflux_tpu_torch.ops.tri import (
    schur_dot,
    trsm_left_lower_unit,
    trsm_right_upper,
    unit_lower,
    upper,
)
from conflux_tpu_torch.precision import ieee_fp32
from conflux_tpu_torch.profiler import span

PIVOTINGS = ("tournament", "gather", "full", "none")


def _select_only(panel, active, v):
    """(piv, ok) of the masked partial-pivoting selection, without the
    merged factor of the winners (`select_pivots` less its forced
    refactor): the tournament needs the factor only from its last
    round."""
    piv, ok, _ = _lu_select_loop_t(panel, active, v, forced=False)
    return piv, ok


def _round_exchange(comm, pi: int, arrays, r: int, Px: int):
    """One butterfly round of candidate exchange over 'x' for any Px:
    rank d receives from butterfly_pair(d, r, Px). Pairs whose source
    sends to one destination go in one ppermute; each source with several
    destinations is one masked psum broadcast. Returns (received arrays,
    src_of [Px])."""
    src_of = [butterfly_pair(d, r, Px) for d in range(Px)]
    pairs = [(s, d) for d, s in enumerate(src_of) if s != d]
    cnt = Counter(s for s, _ in pairs)
    bij = [(s, d) for s, d in pairs if cnt[s] == 1]
    multi = sorted({s for s, _ in pairs if cnt[s] > 1})

    recvs = list(arrays)  # self-receive default
    if bij:
        moved = [comm.ppermute(a, "x", bij) for a in arrays]
        if pi in [d for _, d in bij]:
            recvs = moved
    for s in multi:
        bcast = [comm.psum(a if pi == s else torch.zeros_like(a), "x")
                 for a in arrays]
        if pi in [d for ss, d in pairs if ss == s]:
            recvs = bcast
    return tuple(recvs), src_of


def _merge_round(vals_a, idx_a, vals_b, idx_b, v, last: bool,
                 select=None):
    """One tournament merge: the v best rows among 2v candidates, which
    keep their original panel values. Only the last round's merged factor
    is used, so only it is formed. `select` (panel, active, v) -> (piv,
    ok, lu) replaces the real round kernel (the complex program's
    `lu.cp25d.cselect_pivots`), which then runs every round."""
    vals = torch.cat([vals_a, vals_b])
    idx = torch.cat([idx_a, idx_b])
    if select is not None:
        piv, ok, lu = select(vals, idx >= 0, v)
    elif last:
        piv, ok, lu = select_pivots(vals, idx >= 0, v)
    else:
        (piv, ok), lu = _select_only(vals, idx >= 0, v), None
    win_vals = torch.where(ok[:, None], vals[piv], 0.0)
    win_idx = torch.where(ok, idx[piv], -1)
    return win_vals, win_idx, lu


def _tournament(comm, colk, active, gri, v: int, Px: int, mode: str):
    """The v pivot rows of the step panel, chosen across 'x'. colk [mr, v]
    the reduced panel column, active [mr] the live rows, gri [mr] their
    global rows. Returns (win_idx [v] global rows, lu00 [v, v] merged
    factors of the winners in pivot order), the same on every rank of an
    'x' row (merges take the lower origin first)."""
    if Px == 1:
        piv, ok, lu = select_pivots(colk, active, v)
        return torch.where(ok, gri[piv], -1), lu
    pi = comm.coord("x")
    piv, ok = _select_only(colk, active, v)
    cand_vals = torch.where(ok[:, None], colk[piv], 0.0)
    cand_idx = torch.where(ok, gri[piv], -1)

    if mode == "butterfly":
        rounds = (Px - 1).bit_length()
        lu00 = None
        for r in range(rounds):
            (recv_vals, recv_idx), src_of = _round_exchange(
                comm, pi, (cand_vals, cand_idx), r, Px)
            src = src_of[pi]
            if src == pi:
                # a self-receive round (non-power-of-two Px) merges an
                # empty list, not a duplicate
                recv_vals = torch.zeros_like(recv_vals)
                recv_idx = torch.full_like(recv_idx, -1)
            if src > pi:
                a_vals, a_idx, b_vals, b_idx = (cand_vals, cand_idx,
                                                recv_vals, recv_idx)
            else:
                a_vals, a_idx, b_vals, b_idx = (recv_vals, recv_idx,
                                                cand_vals, cand_idx)
            cand_vals, cand_idx, lu00 = _merge_round(
                a_vals, a_idx, b_vals, b_idx, v, last=r == rounds - 1)
        return cand_idx, lu00

    # 'gather': one all_gather merge of every rank's candidates
    all_vals = comm.all_gather(cand_vals, "x").reshape(Px * v, v)
    all_idx = comm.all_gather(cand_idx, "x").reshape(Px * v)
    piv2, ok2, lu00 = select_pivots(all_vals, all_idx >= 0, v)
    return torch.where(ok2, all_idx[piv2], -1), lu00


def _full_pivot(comm, colk, active, gri, v: int, Px: int):
    """Exact partial pivoting: the whole panel column is gathered over 'x'
    and ordered by global row, so the pivots are the single-device blocked
    LU's for any row layout."""
    mr = colk.shape[0]
    allc = comm.all_gather(colk, "x").reshape(Px * mr, v)
    alla = comm.all_gather(active.to(torch.uint8), "x").reshape(Px * mr) > 0
    allg = comm.all_gather(gri, "x").reshape(Px * mr)
    big = torch.iinfo(allg.dtype).max
    order = torch.argsort(torch.where(allg >= 0, allg, big), stable=True)
    piv, ok, lu00 = select_pivots(allc[order], alla[order], v)
    return torch.where(ok, allg[order][piv], -1), lu00


def _find_local_rows(gri, win_idx):
    """The winner rows among this rank's rows, by global row: (mine [v]
    bool, lr [v] local rows, 0 where absent). Valid for any row layout."""
    eq = gri[:, None] == win_idx[None, :]                  # [mr, v]
    mine = eq.any(dim=0) & (win_idx >= 0)
    lr = eq.to(torch.int32).argmax(dim=0)
    return mine, lr


def _live_rank(comm, active, gri, Mg: int):
    """(act_g [Mg], rank_g [Mg]): the live mask by global row, the same on
    every rank (a 1-D count scatter by global row and a psum over 'x'),
    and each live row's rank among the live rows in ascending order."""
    g = torch.where(gri >= 0, gri, Mg)
    cnt = torch.zeros(Mg + 1, dtype=torch.int32, device=gri.device)
    cnt.index_add_(0, g, active.to(torch.int32))
    act_g = comm.psum(cnt[:Mg], "x") > 0
    return act_g, torch.cumsum(act_g.to(torch.int64), 0) - 1, g


def _rebalance_rows(comm, A, active, gri, Mg: int, Mlp: int, Px: int,
                    chunk: int = 4096):
    """Shrink the working rows from mr to Mlp by moving the globally live
    rows (ascending global row) evenly over 'x': the distributed form of
    the reference's shrinking working set (first_non_pivot_row /
    push_pivots_up, conflux_opt.hpp:176-218). Each rank places its live
    rows at their live-rank slot of a [Px*Mlp, chunk] contribution (zeros
    elsewhere), and one psum_scatter over 'x' per column chunk hands rank
    pi slots [pi*Mlp, (pi+1)*Mlp). z layers move their own partials.
    Returns (A' [Mlp, Nl], active' [Mlp], gri' [Mlp]); pad slots carry
    gri = -1 and are not active."""
    mr, Nl = A.shape
    T = Px * Mlp
    _, rank_g, g = _live_rank(comm, active, gri, Mg)
    slot = torch.where(active, rank_g[g.clamp(0, Mg - 1)], T)
    # the slot map is injective on live rows; slot T collects the others
    inv = torch.zeros(T + 1, dtype=torch.int64, device=A.device)
    inv[slot] = torch.arange(mr, device=A.device)
    has = torch.zeros(T + 1, dtype=torch.bool, device=A.device)
    has[slot] = True
    inv, has = inv[:T], has[:T]
    if Px == 1:
        return (torch.where(has[:, None], A[inv], 0.0), has,
                torch.where(has, gri[inv], -1))
    g2 = comm.psum_scatter(torch.where(has, gri[inv] + 1, 0), "x") - 1
    cols = [comm.psum_scatter(
                torch.where(has[:, None], A[inv, c0:min(c0 + chunk, Nl)],
                            0.0), "x")
            for c0 in range(0, Nl, chunk)]
    A2 = cols[0] if len(cols) == 1 else torch.cat(cols, dim=1)
    return A2, g2 >= 0, g2


def _row_frontier(Mg: int, steps_done: int, v: int, Px: int) -> int:
    """Working-row height once steps_done panels are chosen: ceil(live/Px)
    rounded up to 8 rows, floored at v (the local round draws v
    candidates from the block)."""
    live = Mg - steps_done * v
    return max(-(-v // 8) * 8, -(-live // Px // 8) * 8)


def _tall_tail(desc: BlockCyclic, comm, A, F, active, pivots, gri):
    """Tall (M > N) epilogue: the M - N rows never chosen hold their
    finished multiplier rows in A (layer 0); they go to the factor's tail
    rows N..M-1 in ascending global-row order, and the pivot vector grows
    to length M (LAPACK trapezoid semantics)."""
    v, Px = desc.v, desc.grid.Px
    pi, pz = desc.grid.pi, desc.grid.pz
    Mg, Ng = desc.M, desc.N
    tail = Mg - Ng
    dev = A.device
    act_g, rank_g, g = _live_rank(comm, active, gri, Mg)
    tailpiv = torch.zeros(tail + 1, dtype=torch.int64, device=dev)
    tailpiv[torch.where(act_g, rank_g, tail)] = torch.arange(Mg, device=dev)
    pivots[Ng:] = tailpiv[:tail]
    myrank = torch.where(active, rank_g[g.clamp(0, Mg - 1)], tail)
    contrib = torch.zeros((tail + 1, A.shape[1]), dtype=A.dtype, device=dev)
    if pz == 0:
        contrib[myrank] = torch.where(active[:, None], A, 0.0)
    rows = comm.psum(contrib[:tail], ("x", "z"))            # [tail, Nl]
    gslot = Ng + torch.arange(tail, device=dev)
    mine = (gslot // v) % Px == pi
    if pz == 0:
        lrow = (gslot // v) // Px * v + gslot % v
        F[lrow[mine]] = rows[mine]
    return F, pivots


def _trailing_sub(A, Lk, Yk, c0: int, c1: int, precision: str, active):
    """A[:, c0:c1] -= where(active, Lk @ Yk, 0) in place: the step-6
    trailing update (conflux_opt.hpp:1626-1634). A bf16 A (bf16 storage)
    takes 'bf16out' whatever `precision` says. In 'high' and 'bf16' on a
    float32 A, and 'bf16out' on a bf16 one, when the span runs to A's last
    column and the update rank l is a multiple of 128 (the JAX package's
    conditions, less its TPU-only operand-size gate), K3
    (`ops/gemm.schur_update`) fuses it, with the row mask folded into Lk's
    rows; otherwise (float64 included) a product of `schur_dot` and a
    masked subtraction."""
    m, n = A.shape
    l = Lk.shape[1]
    mode = "bf16out" if A.dtype == torch.bfloat16 else precision
    fused = (mode == "bf16out" or (A.dtype == torch.float32
                                   and mode in ("high", "bf16")))
    if c1 == n and fused and l % 128 == 0:
        schur_update(A, torch.where(active[:, None], Lk, 0.0), Yk, c0, mode)
        return
    upd = schur_dot(Lk, Yk, mode)
    A[:, c0:c1] -= torch.where(active[:, None], upd, 0.0)


def _rebalance_steps(variant: str, Nt: int, Px: int, rowpart, windows):
    """The steps after which the program rebalances its rows."""
    if variant in ("unrolled", "lookahead"):
        rp = Px if rowpart is None else rowpart
        return {k for k in range(Nt - 1) if rp and (k + 1) % rp == 0}
    if variant == "windowed" and (rowpart is None or rowpart):
        return {lo - 1 for lo, _ in segment_bounds(Nt, windows) if lo > 0}
    return set()


def _choose_pivots(comm, pivoting: str, colk, active, gri, k: int, v: int,
                   Px: int, own_y: bool):
    """Step 1 on this rank's reduced panel column colk [mr, v]: (win_idx
    [v] global rows in pivot order, lu00 [v, v] merged factor of the
    winners), the same on every rank of an 'x' column. 'none' takes the
    diagonal tile's rows (EmptyPivot, python/pivoting.py:17-76), located
    by global row, from the owner column (one psum over ('x', 'y'))."""
    if pivoting in ("tournament", "gather"):
        return _tournament(comm, colk, active, gri, v, Px,
                           "butterfly" if pivoting == "tournament"
                           else "gather")
    if pivoting == "full":
        return _full_pivot(comm, colk, active, gri, v, Px)
    win_idx = k * v + torch.arange(v, device=colk.device)
    mine_n, dlr = _find_local_rows(gri, win_idx)
    dcontrib = torch.where(mine_n[:, None], colk[dlr], 0.0)
    a00 = comm.psum(dcontrib if own_y else torch.zeros_like(dcontrib),
                    ("x", "y"))
    return win_idx, lu_nopivot(a00)


def _pivot_blocks(lu00):
    """(L00, U00) of the winners' merged factor. An exactly-zero pivot
    (rank-deficient panel) is 1 in the solves, so the factors stay finite
    (LAPACK getrf's skip-scaling)."""
    U00 = upper(lu00)
    U00 = U00 + torch.diag((torch.diagonal(U00) == 0).to(U00.dtype))
    return unit_lower(lu00), U00


def _local_lu_25d(desc: BlockCyclic, pivoting: str, precision: str,
                  G: torch.Tensor, rebalance_after=(),
                  lookahead: bool = False, region=span):
    """The right-looking rank program on this rank's block G (not
    modified). Returns (F [Ml, Nl], this rank's block of the merged
    factor in pivot order, and pivots [M], the same on every rank).
    region(name) is entered around each substep (step0_reduce,
    step1_pivot, step23_rows, step45_trsm, step6_update): the profiled
    program's fenced timers (lu/profiled.py); `profiler.span` otherwise
    (a null context unless profiled)."""
    g = desc.grid
    comm = g.comm
    v, Px, Py, Pz = desc.v, g.Px, g.Py, g.Pz
    Nl, Nt = desc.Nl, desc.Nt
    l = desc.nlayr         # per-layer update rank ceil(v/Pz) (lu_params.hpp:73)
    kpad = Pz * l - v      # zero pad so the last layer's slice is in bounds
    pi, pj, pz = g.pi, g.pj, g.pz
    dev = G.device

    gri = local_row_to_global(pi, Px, v, desc.Ml, dev)   # global row of each row
    gt_col = local_tile_to_global(pj, Py, v, Nl, dev)    # global tile of each col
    cdt = compute_dtype(G.dtype)   # A and F keep G's (storage) dtype
    A = G.clone()
    F = torch.zeros_like(A)
    active = torch.ones(desc.Ml, dtype=torch.bool, device=dev)
    pivots = torch.zeros(desc.M, dtype=torch.int64, device=dev)

    colnext = comm.psum(A[:, :v].to(cdt), "z") if lookahead else None
    for k in range(Nt):
        mr = A.shape[0]         # working height (shrinks at a rebalance)
        c0 = (k // Py) * v      # frozen-column frontier
        r0f = (k // Px) * v     # output-block row offset
        own_y = pj == k % Py
        own_x = pi == k % Px

        # -- step 0: lazy z-reduction of the panel column --------------------
        with region("step0_reduce"):
            colk = (colnext if lookahead
                    else comm.psum(A[:, c0:c0 + v].to(cdt), "z"))

        # -- step 1: pivot selection over 'x' ---------------------------------
        with region("step1_pivot"):
            win_idx, lu00 = _choose_pivots(comm, pivoting, colk, active, gri,
                                           k, v, Px, own_y)
            if pivoting != "none":
                # selection ran on owner-column data: broadcast over 'y'
                # (gpivots bcast, conflux_opt.hpp:863-872)
                win_idx = comm.psum(win_idx if own_y
                                    else torch.zeros_like(win_idx), "y")
                lu00 = comm.psum(lu00 if own_y else torch.zeros_like(lu00),
                                 "y")
            pivots[k * v:(k + 1) * v] = win_idx
            mine, lr = _find_local_rows(gri, win_idx)
            active &= ~(gri[:, None] == win_idx[None, :]).any(dim=1)

        # -- steps 2+3: the v pivot rows, full width, on every rank ----------
        # trailing columns are z-partials and frozen L columns live on layer
        # 0, so one masked psum over ('x', 'z') gives the true rows
        with region("step23_rows"):
            raw = comm.psum(torch.where(mine[:, None], A[lr], 0.0).to(cdt),
                            ("x", "z"))

        # -- steps 4+5: TRSMs ---------------------------------------------------
        with region("step45_trsm"):
            L00, U00 = _pivot_blocks(lu00)
            Y = trsm_left_lower_unit(L00, raw[:, c0:], method="invert")
            if own_x and pz == 0:
                # the output block row: L columns keep their raw values, the
                # panel tile is lu00, trailing columns U01 = Y
                F[r0f:r0f + v, :c0] = raw[:, :c0]
                F[r0f:r0f + v, c0:] = torch.where(gt_col[None, c0:] > k, Y,
                                                  raw[:, c0:])
                if own_y:
                    F[r0f:r0f + v, c0:c0 + v] = lu00
            L10 = trsm_right_upper(colk, U00, method="invert")
            L10 = torch.where(active[:, None], L10, 0.0)
            if own_y:
                A[:, c0:c0 + v] = L10 if pz == 0 else 0.0

        # -- step 6: split-K trailing update (layer pz takes an l slice) -----
        # only that slice of L10 is broadcast over 'y' (the reference's
        # per-layer Iscatterv on jk_comm, conflux_opt.hpp:1424-1434)
        with region("step6_update"):
            L10p = torch.nn.functional.pad(L10, (0, kpad)) if kpad else L10
            Lk = comm.psum(L10p[:, pz * l:(pz + 1) * l] if own_y
                           else L10.new_zeros((mr, l)), "y")       # [mr, l]
            Ymask = torch.where(gt_col[None, c0:] > k, Y, 0.0)
            if kpad:
                Ymask = torch.nn.functional.pad(Ymask, (0, 0, 0, kpad))
            Yk = Ymask[pz * l:(pz + 1) * l]                        # [l, Nl-c0]
            if lookahead and k + 1 < Nt:
                # the next step's panel column first (all its tournament
                # needs), then the rest of the window with that slice zeroed
                c1 = ((k + 1) // Py) * v
                _trailing_sub(A, Lk, Yk[:, c1 - c0:c1 - c0 + v].contiguous(),
                              c1, c1 + v, precision, active)
                colnext = comm.psum(A[:, c1:c1 + v].to(cdt), "z")
                Yk = Yk.clone()
                Yk[:, c1 - c0:c1 - c0 + v] = 0.0
            _trailing_sub(A, Lk, Yk, c0, Nl, precision, active)

        # -- row frontier: shed the dead rows --------------------------------
        if k in rebalance_after:
            Mlp = _row_frontier(desc.M, k + 1, v, Px)
            if Mlp < mr:
                A, active, gri = _rebalance_rows(comm, A, active, gri,
                                                 desc.M, Mlp, Px)
                if lookahead:
                    # colnext's rows moved with A; its column is already
                    # updated, so one z-reduction refreshes it
                    c1 = ((k + 1) // Py) * v
                    colnext = comm.psum(A[:, c1:c1 + v].to(cdt), "z")

    if desc.M > desc.N:
        F, pivots = _tall_tail(desc, comm, A, F, active, pivots, gri)
    return F, pivots


def crout_rowpart_default(Px: int, Nt: int) -> int:
    """The crout rank program's rebalance cadence: the optimum tracked
    ~Nt/4 rebalances, capped at a frontier shrink of 4 panels per rank
    row (the JAX package's cadence sweeps, measured on a TPU). The crout
    program has no trailing update, so stale frontiers cost it less than
    the right-looking programs, whose default stays Px."""
    return max(Px, min(4 * Px, -(-Nt // 4)))


def _local_lu_25d_crout(desc: BlockCyclic, pivoting: str, precision: str,
                        G: torch.Tensor, rowpart=None):
    """The left-looking (crout) rank program on this rank's block G (not
    modified): no trailing update. Returns (F, pivots) as `_local_lu_25d`.

    A's frozen panel columns hold L multipliers on layer 0 of the owner
    column (exact zeros on the other layers); its other columns keep the
    raw z-partials and are never written. F's row block li holds step
    li*Px + pi's pivot rows for this rank's columns, on layer 0: the U
    rows the big-K products read. Per step k:

      step 0  the U slab of the panel column (F[:nmy v, c0:c0+v] on the
              owner column) is psum'd over 'y', all_gather'd over 'x' and
              reordered to global step order; each rank takes
              Lfrozen @ slab_sel (`schur_dot` in the step's mode), and one
              [mr, v] psum over ('y', 'z') of (raw partials on the owner
              column minus the layer-0 product) gives colk to every rank;
      step 1  pivoting as in the right-looking program, on colk, which is
              the same on every rank of a 'y' row, so the winners need no
              broadcast. At Px == 1 ('tournament', 'gather') the local
              elimination is the tournament: `factor_panel_raw(...,
              block=128, merged=False)` (K1 unforced with finish) gives
              the multipliers and the winners' finished rows, written into
              A before the pivot rows are gathered;
      steps 2+3  the raw pivot rows by one psum over ('x', 'z') (at
              Px == 1 their panel block is lu00, replicated by one [v, v]
              psum over 'y'); the winners' L history is all_gather'd over
              'y', and the U12 correction schur_dot(Lmy, Fmy) psum'd over
              'x';
      steps 4+5  the TRSMs and the F and panel writes.

    The all_gathers have the same size on every rank: nbf = ceil(k/Py)
    frozen local column tiles and nmy = ceil(k/Px) F row blocks are
    bounds every rank shares; tiles past step k pair with zero U rows
    (unwritten F blocks), and the reorders pad to NB global tiles.
    rowpart: the rebalance cadence (None = crout_rowpart_default, 0 =
    never); `_rebalance_rows` moves the z-partials and L columns with the
    rows."""
    g = desc.grid
    comm = g.comm
    v, Px, Py = desc.v, g.Px, g.Py
    Nl, Nt = desc.Nl, desc.Nt
    pi, pj, pz = g.pi, g.pj, g.pz
    dev = G.device
    if rowpart is None:
        rowpart = crout_rowpart_default(Px, Nt)

    gri = local_row_to_global(pi, Px, v, desc.Ml, dev)
    gt_col = local_tile_to_global(pj, Py, v, Nl, dev)
    bf16s = G.dtype == torch.bfloat16
    cdt = compute_dtype(G.dtype)   # A and F keep G's (storage) dtype
    gmode = "bf16" if bf16s else precision    # the big-K products' mode
    A = G.clone()
    F = torch.zeros_like(A)
    active = torch.ones(desc.Ml, dtype=torch.bool, device=dev)
    pivots = torch.zeros(desc.M, dtype=torch.int64, device=dev)
    # Px == 1: the local round is the final one, so its multipliers are
    # L10 (the fused panel). It also finishes the winners' rows (merged=
    # False, `fin`), except under bf16 storage, where lu00 must stay f32
    # for the TRSMs instead of passing through the bf16 block
    fused = Px == 1 and pivoting in ("tournament", "gather")
    fin = fused and not bf16s
    gather_free = Px == 1 and Py == 1      # the reorders are identities

    for k in range(Nt):
        mr = A.shape[0]
        c0 = (k // Py) * v
        r0f = (k // Px) * v
        own_y = pj == k % Py
        own_x = pi == k % Px
        nbf = -(-k // Py)      # frozen local column tiles (a shared bound)
        nmy = -(-k // Px)      # this rank's F row blocks (a shared bound)
        NB = max(nbf * Py, nmy * Px)   # padded global tile count

        # -- step 0: panel assembly ------------------------------------------
        partial = None
        if k > 0:
            slab_my = F[:nmy * v, c0:c0 + v]
            slab_my = comm.psum(slab_my if own_y
                                else torch.zeros_like(slab_my), "y")
            if gather_free:
                slab_sel = slab_my
            else:
                # step r = li*Px + p sits at [p, li] of the gather
                slab = comm.all_gather(slab_my, "x")       # [Px, nmy*v, v]
                slab = slab.reshape(Px, nmy, v, v).transpose(0, 1)
                slab = slab.reshape(nmy * Px, v, v)
                if NB > nmy * Px:
                    slab = torch.cat([slab, slab.new_zeros(
                        (NB - nmy * Px, v, v))])
                # the global tiles of my frozen local columns
                idx = torch.arange(nbf, device=dev) * Py + pj
                slab_sel = slab[idx].reshape(nbf * v, v)
            if pz == 0:         # frozen columns are zeros on other layers
                partial = schur_dot(A[:, :nbf * v], slab_sel, gmode)
        rawp = (A[:, c0:c0 + v].to(cdt) if own_y
                else A.new_zeros((mr, v), dtype=cdt))
        colk = comm.psum(rawp if partial is None else rawp - partial,
                         ("y", "z"))

        # -- step 1: pivot selection ------------------------------------------
        if fused:
            piv_l, ok_l, Mloc, lu00 = factor_panel_raw(colk, active, v,
                                                       block=128,
                                                       merged=not fin)
            win_idx = torch.where(ok_l, gri[piv_l], -1)
            mine, lr = ok_l, piv_l
        else:
            win_idx, lu00 = _choose_pivots(comm, pivoting, colk, active, gri,
                                           k, v, Px, own_y)
            mine, lr = _find_local_rows(gri, win_idx)
        pivots[k * v:(k + 1) * v] = win_idx
        if fin and own_y:
            # live rows take their multipliers, the winners their finished
            # merged rows (carried out by the pivot-row psum below); rows
            # dead before this step take zeros (uneliminated, their values
            # would compound from step to step until a rebalance)
            A[:, c0:c0 + v] = (torch.where(active[:, None], Mloc, 0.0)
                               if pz == 0 else 0.0)
        active &= ~(gri[:, None] == win_idx[None, :]).any(dim=1)

        # -- steps 2+3: the raw pivot rows and their U12 correction ----------
        raw = comm.psum(torch.where(mine[:, None], A[lr], 0.0).to(cdt),
                        ("x", "z"))
        if fin:
            lu00 = comm.psum(raw[:, c0:c0 + v] if own_y
                             else raw.new_zeros((v, v)), "y")
        rhs = raw[:, c0:]
        if k > 0:
            # the winners' L history in global column order
            Lloc = raw[:, :nbf * v]
            if gather_free:
                Lmy = Lloc
            else:
                Lg = comm.all_gather(Lloc, "y")            # [Py, v, nbf*v]
                Lg = Lg.reshape(Py, v, nbf, v).permute(1, 2, 0, 3)
                Lg = Lg.reshape(v, nbf * Py * v)
                if NB > nbf * Py:
                    Lg = torch.nn.functional.pad(
                        Lg, (0, (NB - nbf * Py) * v))
                idxm = torch.arange(nmy, device=dev) * Px + pi
                Lmy = Lg.reshape(v, NB, v)[:, idxm].reshape(v, nmy * v)
            # my U rows of the live window; rows of unwritten steps are
            # zero, and columns of tiles <= k are masked below
            corr = comm.psum(schur_dot(Lmy, F[:nmy * v, c0:], gmode), "x")
            rhs = rhs - corr

        # -- steps 4+5: TRSMs and the factor and panel writes ----------------
        L00, U00 = _pivot_blocks(lu00)
        Y = trsm_left_lower_unit(L00, rhs, method="invert")       # [v, nw]
        if own_x and pz == 0:
            F[r0f:r0f + v, :c0] = raw[:, :c0]
            F[r0f:r0f + v, c0:] = torch.where(gt_col[None, c0:] > k, Y,
                                              raw[:, c0:])
            if own_y and not fin:
                # (the finished panel's raw carries lu00 there already)
                F[r0f:r0f + v, c0:c0 + v] = lu00
        if not fin:
            # the fused panel's multipliers are L10 (bf16 storage); else
            # the TRSM against the winners' U00
            L10 = (Mloc if fused
                   else trsm_right_upper(colk, U00, method="invert"))
            if own_y:
                A[:, c0:c0 + v] = (torch.where(active[:, None], L10, 0.0)
                                   if pz == 0 else 0.0)

        # -- row frontier ----------------------------------------------------
        if rowpart and (k + 1) % rowpart == 0 and k + 1 < Nt:
            Mlp = _row_frontier(desc.M, k + 1, v, Px)
            if Mlp < mr:
                A, active, gri = _rebalance_rows(comm, A, active, gri,
                                                 desc.M, Mlp, Px)

    if desc.M > desc.N:
        F, pivots = _tall_tail(desc, comm, A, F, active, pivots, gri)
    return F, pivots


def _check(G: torch.Tensor, desc: BlockCyclic, pivoting: str):
    if desc.M < desc.N:
        raise ConfluxError(ErrorCode.INVALID_SHAPE,
                           "distributed LU requires M >= N (tall or square)")
    check_dtype(G, "lu_25d")
    if pivoting not in PIVOTINGS:
        raise ConfluxError(ErrorCode.INVALID_SHAPE,
                           f"unknown pivoting {pivoting!r}; expected one of "
                           f"{PIVOTINGS}")
    if tuple(G.shape) != (desc.Ml, desc.Nl):
        raise ConfluxError(ErrorCode.LAYOUT_MISMATCH,
                           f"block {tuple(G.shape)} is not the descriptor's "
                           f"{(desc.Ml, desc.Nl)}")


@ieee_fp32()
def lu_25d(G: torch.Tensor, desc: BlockCyclic, pivoting: str = "tournament",
           precision: str = "highest", unroll=None, windows: int = 8,
           rowpart=None):
    """Distributed LU of this rank's [Ml, Nl] block G of the z-partial
    layout (`layout.distribute` makes one). Returns (F, pivots): this
    rank's block of the merged LU factors of P·A in the same layout (rows
    in pivot order, layer 0; conflux_opt.hpp:1660-1696) and the global
    pivot vector, pivots[s] = the original row at slot s (int64, the same
    on every rank); (None, None) on an idle rank. Every rank of the grid
    must call it.

    pivoting: 'tournament' (butterfly CALU), 'gather' (single-merge
    CALU), 'full' (exact partial pivoting) or 'none' (EmptyPivot).
    precision: the trailing-update mode ('highest', 'high', 'bf16'); the
    panel math and TRSMs stay IEEE fp32. G float32, float64 or bfloat16
    (storage: the module docstring). unroll: None auto-selects
    (dispatch.choose_variant), True/False force 'unrolled'/'fori', or a
    variant name (module docstring).
    rowpart: the rebalance cadence of 'unrolled'/'lookahead' (None = Px,
    0 = never) and of 'crout' (None = crout_rowpart_default(Px, Nt), 0 =
    never); for 'windowed', None or any truthy value rebalances at each
    window boundary and 0 disables. Rebalancing moves rows across
    'x', which changes the tournament's candidate groups: CALU pivots
    depend on the tree by construction; 'full' and 'none' do not.

    A (1, 1, 1) grid with 'tournament', 'gather' or 'full' runs
    `lu.single.lu_factor`'s 'auto' on G, whose desc.M rows are the whole
    matrix there (every strategy is exact partial pivoting there), and
    whose F and perm have the same layout."""
    if desc.grid.idle:
        return None, None
    _check(G, desc, pivoting)
    variant = normalize_variant(unroll, desc, "lu")
    if desc.grid.P == 1 and pivoting != "none":
        return lu_factor(G, desc.v, precision)
    if variant == "crout":
        return _local_lu_25d_crout(desc, pivoting, precision, G, rowpart)
    return _local_lu_25d(
        desc, pivoting, precision, G,
        rebalance_after=_rebalance_steps(variant, desc.Nt, desc.grid.Px,
                                         rowpart, windows),
        lookahead=variant == "lookahead")


@ieee_fp32()
def plu(A, grid, v: int = 128, pivoting: str = "tournament",
        precision: str = "highest", unroll=None, root: int = 0):
    """Dense [M, N] matrix (numpy or a tensor, on every rank) -> (F, perm):
    the dense merged LU of P·A on grid rank `root` (None elsewhere) and
    the pivot vector on every rank. The distributed analog of `LU_rep` and
    the miniapp's validation assembly (conflux_miniapp.cpp:349-507).

    When the shape is not a multiple of the grid tiling, F and perm
    describe the identity-PADDED problem (`layout.pad_like(A, desc)`), as
    in the reference (lu_params.hpp:67-71)."""
    desc = BlockCyclic.create(A.shape[0], A.shape[1], v, grid)
    F, pivots = lu_25d(distribute(A, desc), desc, pivoting, precision,
                       unroll)
    if desc.grid.P == 1 or F is None:
        return F, pivots
    return undistribute(F, desc, root), pivots
