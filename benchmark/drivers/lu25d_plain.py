"""CALU, LU with tournament pivoting, in plain PyTorch: the plain reference
of the 2.5D LU (`conflux_tpu_torch.lu.p25d.lu_25d`, pivoting
'tournament'), written from the upstream's description. It imports
torch and the benchmark's plain reference (`benchmark.reference`, for
its IEEE fp32 pin and TF32 rounding), nothing of the program.

    F, perm = calu(A, v, Px)                  # IEEE fp32 products
    F, perm = calu(A, v, Px, tf32=True)       # products on TF32 operands

A is an [N, N] float32 matrix, N a multiple of v * Px. Step k factors the
v columns c = k*v .. c+v of the working matrix W:

  1. the tournament: the live rows are split into Px groups by the
     block-cyclic row layout, group p holding the rows r with
     (r // v) % Px == p (the rows of x coordinate p; they never move,
     as in the program's 'fori' row layout). A partial-pivoting LU of each
     group's live panel rows picks up to v candidates in pivot order;
     then ceil(log2 Px) butterfly rounds merge them: in round r group p
     takes the candidates of group butterfly_pair(p, r, Px), the lower
     coordinate's first, and keeps the v rows a partial-pivoting LU of
     the merged 2v picks. Every candidate carries its panel values as
     they were at the start of the step. The winners of group 0 are the
     step's pivot rows;
  2. the winners' merged factor lu00 = L00 U00 is the LU without pivoting
     of their panel rows;
  3. the winners' trailing columns become U01 = L00^-1 W[win, c+v:], the
     live rows' panel columns L10 = W[live, c:c+v] U00^-1, and the
     trailing update W[live, c+v:] -= L10 @ U01, the one matrix product
     of the step, in IEEE fp32 (or, with tf32, on operands rounded to
     TF32's 10 mantissa bits, to nearest, ties away from zero, with fp32
     accumulation: the precision one step below float32 with TF32 off,
     the same on the card and the CPU).

F = W[perm] is the merged L\\U of A[perm] (unit lower L), perm the pivot
rows in order, so A[perm] = L U. A partial-pivoting LU here is the plain
unblocked one: per column, the live row of largest magnitude (the first
such row on a tie) is the pivot, and the rows below it take one rank-1
update in fp32.

Departures from the upstream's tournament (`tournament_rounds` and its
caller, conflux_opt.hpp:220-336 and :693-838, as the repository's
SURVEY.md records them):

  * float32 throughout (the upstream runs double);
  * each candidate selection is an unblocked fp32 elimination, where the
    upstream calls LAPACK's dgetrf on the [2v, v] candidate block; the
    candidates carry their global row as a separate list, not as a
    prepended column 0 of the block;
  * the rows stay where the block-cyclic layout puts them for the whole
    run (the 'fori' layout): the upstream's working set shrinks as it
    pushes the pivots up (push_pivots_up, :176), so its groups change
    from step to step, as the program's do at a row rebalance;
  * a round's merge lists the lower coordinate's candidates first; a
    group that butterfly_pair pairs with itself (Px not a power of two)
    merges an empty list;
  * lu00 is recomputed from the winners' panel rows by an LU without
    pivoting, in place of the last round's getrf output;
  * no 2.5D replication: one layer, so no z reduction (the deployment's
    grid is (2, 2, 1)), and the triangular solves are
    `torch.linalg.solve_triangular` (the upstream's dtrsm).
"""

from __future__ import annotations

import torch

from benchmark.reference import ieee, tf32_round


def butterfly_pair(p: int, r: int, Px: int) -> int:
    """The partner of coordinate p in butterfly round r for any Px
    (conflux_opt.cpp:59-72): the bit-r partner, folded back into the grid
    where it falls beyond it."""
    src = p ^ (1 << r)
    if src >= Px:
        if r == 0:
            return p
        src = src ^ (1 << (r - 1))
        if src >= Px:
            src = Px - 1
    return src


def select(P: torch.Tensor, npiv: int) -> torch.Tensor:
    """The rows of P [m, w] that a partial-pivoting LU picks for its first
    min(npiv, m) columns, in pivot order (int64 indices into P)."""
    W = P.clone()
    m = W.shape[0]
    avail = torch.ones(m, dtype=torch.bool, device=W.device)
    piv = []
    for j in range(min(npiv, m)):
        p = torch.where(avail, W[:, j].abs(), -1.0).argmax()
        avail[p] = False
        piv.append(p)
        prow = W[p]
        mult = torch.where(avail & (prow[j] != 0), W[:, j] / prow[j], 0.0)
        W[:, j + 1:] -= mult[:, None] * prow[None, j + 1:]
    return torch.stack(piv)


def lu_nopivot(T: torch.Tensor) -> torch.Tensor:
    """The merged L\\U of the square T without pivoting (unit lower L)."""
    W = T.clone()
    for j in range(W.shape[0] - 1):
        W[j + 1:, j] /= W[j, j]
        W[j + 1:, j + 1:] -= W[j + 1:, j, None] * W[j, None, j + 1:]
    return W


def tournament(panel: torch.Tensor, live: list, v: int, Px: int) -> list:
    """The step's v pivot rows (global rows, in pivot order) chosen from
    the live rows of panel [N, v] by the butterfly tournament."""
    dev = panel.device
    cands = []
    for p in range(Px):
        rows = [r for r in live if (r // v) % Px == p]
        if not rows:
            cands.append([])
            continue
        idx = torch.tensor(rows, device=dev)
        cands.append(idx[select(panel[idx], v)].tolist())
    for r in range((Px - 1).bit_length()):
        merged = []
        for p in range(Px):
            src = butterfly_pair(p, r, Px)
            if src == p:
                both = cands[p]
            elif src > p:
                both = cands[p] + cands[src]
            else:
                both = cands[src] + cands[p]
            idx = torch.tensor(both, device=dev, dtype=torch.int64)
            merged.append(idx[select(panel[idx], v)].tolist()
                          if both else [])
        cands = merged
    return cands[0]


def calu(A: torch.Tensor, v: int, Px: int, tf32: bool = False):
    """(F, perm): CALU of the float32 [N, N] A in steps of v columns over
    Px row groups (module docstring); A[perm] = L U, F merged."""
    n = A.shape[0]
    if A.shape != (n, n) or n % (v * Px):
        raise ValueError(f"A {tuple(A.shape)} is not square with N a "
                         f"multiple of v * Px = {v * Px}")
    dev = A.device
    with ieee():
        W = A.to(torch.float32).clone()
        live = list(range(n))
        perm = []
        for k in range(n // v):
            c = k * v
            win = tournament(W[:, c:c + v], live, v, Px)
            perm += win
            chosen = set(win)
            live = [r for r in live if r not in chosen]
            wi = torch.tensor(win, device=dev)
            lu00 = lu_nopivot(W[wi, c:c + v])
            W[wi, c:c + v] = lu00
            W[wi, c + v:] = torch.linalg.solve_triangular(
                lu00, W[wi, c + v:], upper=False, unitriangular=True)
            if not live:
                continue
            li = torch.tensor(live, device=dev)
            L10 = torch.linalg.solve_triangular(
                torch.triu(lu00), W[li, c:c + v], upper=True, left=False)
            W[li, c:c + v] = L10
            U01 = W[wi, c + v:]
            if tf32:
                L10, U01 = tf32_round(L10), tf32_round(U01)
            W[li, c + v:] -= L10 @ U01
        perm = torch.tensor(perm, device=dev)
        return W[perm], perm
