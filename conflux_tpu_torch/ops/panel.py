"""Panel factorization: masked partial-pivoting row selection.

PyTorch counterpart of `conflux_tpu/ops/panel.py`. Rows are never swapped
or compacted here: a validity mask and a pivot index vector carry the
selection, so an unavailable row simply never wins the masked argmax.

The panel lives TRANSPOSED [n, m] for the whole factorization (panel
columns as rows, matrix rows as lanes). Per `_BLOCK`-wide column block
the rank-1 eliminations run in K1 (ops/cuda_panel.py, CUDA tensors) or in
its plain version `_rank1_block_t` (CPU tensors); between blocks the
trailing panel columns are updated in transposed space: the block's pivot
lanes gathered by index, the pivot triangle's solve, the multiplier outer
product, and, where the elimination finishes its pivot lanes, their U12
scattered back by index. The lane moves run in the hand-written kernels
of ops/cuda_lanes.py on CUDA tensors and in their plain versions
(`_gather_lanes`, `_scatter_lanes`) on CPU tensors; they move values
exactly, where the JAX package forms them by one-hot products over all m
lanes. The triangle's solve runs in the hand-written kernel of
ops/cuda_trsm.py on CUDA tensors and in its plain version
`_pivot_solve_plain` on CPU tensors (`_pivot_solve_t`). Every product
here forms multipliers or factors, so every one runs in IEEE fp32, or in
f64 on a float64 panel (whose blocks take K1 in double on the card).
"""

from __future__ import annotations

import torch

from conflux_tpu_torch.ops.tri import _inv_lower_rec, trsm_right_lower_t

# micro-panel width of the two-level rank-1 block (the JAX kernel's _SUB)
_SUB = 32
# rank-1 loop width of `_lu_select_loop_t` when the caller names none
_BLOCK = 64
# outer regrouping width of the inter-block updates: per-block updates
# touch only their group's rows; rows beyond the group get one K=_GROUP
# update per group boundary
_GROUP = 512

# pivot-lane gathers and scatters issued by `_lu_select_loop_t` in this
# process (either version); the tests read it
LANE_MOVES = 0


def _rank1_block_t(Mt: torch.Tensor, availf: torch.Tensor, j0: int,
                   forced: bool, finish: bool = False):
    """Plain PyTorch version of K1 on a TRANSPOSED [w, m] block, kept
    structurally identical to the JAX twin (`conflux_tpu/ops/panel
    ._rank1_block_t`): `_SUB`-wide micro-panels of rank-1 steps, then one
    deferred update of the later rows per micro-panel boundary.

    Mt [w, m]; availf [1, m] (> 0 = selectable). Returns (Mt' [w, m],
    availf' [1, m], piv [w] i64, ok [w] bool). The inputs are not
    modified."""
    w, m = Mt.shape
    dev, dt = Mt.device, Mt.dtype
    # both are updated in place below; the caller's tensors stay as given
    Mt = Mt.clone()
    availf = availf.clone()
    lanes = torch.arange(m, device=dev)[None, :]
    piv = torch.zeros(w, dtype=torch.int64, device=dev)
    ok = torch.zeros(w, dtype=torch.bool, device=dev)

    def deferred(d0: int, d1: int, e: int):
        """Update rows [d1, e) by the factored rows [d0, d1): pivot-lane
        extraction by one-hot products, inv(L11).T by the nilpotent
        Neumann product, then the multiplier outer product."""
        b = d1 - d0
        onehot = ((lanes == piv[d0:d1, None]) & ok[d0:d1, None]).to(dt)
        Msub = Mt[d0:d1]
        T = Mt[d1:e]
        G = Msub @ onehot.T                                       # [b, b]
        Tpiv = T @ onehot.T                                       # [e-d1, b]
        eye = torch.eye(b, dtype=dt, device=dev)
        St = torch.triu(G, 1)
        invT = eye - St
        P = St
        p = 2
        while p < b:
            P = P @ P
            invT = (eye + P) @ invT
            p *= 2
        U12 = Tpiv @ invT
        Lmul = torch.where(availf > 0, Msub, 0.0)
        Tnew = T - U12 @ Lmul
        if forced or finish:
            # the block's pivot lanes get their exact U12 instead of going
            # stale (the kernel's forced/finish write)
            anyp = onehot.sum(dim=0, keepdim=True) > 0
            Tnew = torch.where(anyp, U12 @ onehot, Tnew)
        Mt[d1:e] = Tnew

    for s0 in range(0, w, _SUB):
        b = min(_SUB, w - s0)
        s1 = s0 + b
        sub_iota = torch.arange(b, device=dev)[:, None]
        for jloc in range(b):
            jj = s0 + jloc
            col = Mt[jj:jj + 1].clone()                           # [1, m]
            if forced:
                p = torch.tensor(j0 + jj, device=dev)
            else:
                score = torch.where(availf > 0, col.abs(), -torch.inf)
                # first maximal lane: ties break to the lowest row index
                p = torch.argmax(score)
            is_p = lanes == p
            piv[jj] = p
            ok[jj] = torch.where(is_p, availf, 0.0).sum() > 0
            pv = torch.where(is_p, col, 0.0).sum()
            safe = torch.where(pv == 0, torch.ones_like(pv), pv)
            elim = (availf > 0) & ~is_p
            mult = torch.where(elim, col / safe, 0.0)
            Msub = Mt[s0:s1]
            pivcol = torch.where(is_p, Msub, 0.0).sum(dim=1, keepdim=True)
            pivcol = torch.where(sub_iota > jloc, pivcol, 0.0)
            Mt[s0:s1] = Msub - pivcol * mult
            Mt[jj:jj + 1] = torch.where(elim, mult, col)
            availf = torch.where(is_p, 0.0, availf)
        if s1 < w:
            deferred(s0, s1, w)
    return Mt, availf, piv, ok


def _rank1_dispatch(Bt: torch.Tensor, availf: torch.Tensor, j0: int,
                    forced: bool, finish: bool = False):
    """K1 for a CUDA block (float32, or K1 in double for float64), its
    plain version for a CPU block of any real dtype; anything else raises.
    There is no fallback between the two."""
    if Bt.is_cuda:
        from conflux_tpu_torch.ops import cuda_panel

        k1 = (cuda_panel.rank1_block_t_f64 if Bt.dtype == torch.float64
              else cuda_panel.rank1_block_t)
        Bt2, availf2, pivw, okw = k1(Bt, availf, forced, j0, finish=finish)
        return Bt2, availf2, pivw, okw > 0
    if Bt.device.type == "cpu":
        return _rank1_block_t(Bt, availf, j0, forced, finish)
    raise ValueError(f"no rank-1 block kernel for device {Bt.device}")


def _pivot_solve_plain(Tpiv_t: torch.Tensor, lu: torch.Tensor,
                       group: bool) -> torch.Tensor:
    """Plain PyTorch version of the pivot-triangle solve: U12t = Tpiv_t
    L^{-T}, L = tril(lu, -1) + I, with the JAX package's arithmetic: a
    block's triangle by its explicit inverse, a group's (group=True) by
    blocked substitution; both invert no triangle wider than 32 (pivot-
    multiplier triangles amplify like c^n)."""
    n = lu.shape[0]
    L11 = torch.tril(lu, -1) + torch.eye(n, dtype=lu.dtype, device=lu.device)
    if group:
        return trsm_right_lower_t(Tpiv_t, L11, method="invert")
    return Tpiv_t @ _inv_lower_rec(L11, unit=True, base=32).T


def _pivot_solve_t(Tpiv_t: torch.Tensor, lu: torch.Tensor,
                   group: bool) -> torch.Tensor:
    """U12t = Tpiv_t L^{-T} with L the unit lower triangle of the pivot
    rows' merged factors lu [n, n] (column-major, as the pivot-lane gather
    leaves it). The hand-written kernel (ops/cuda_trsm.py) for CUDA
    tensors, whatever `group`; the plain version for CPU tensors; anything
    else raises. There is no fallback between the two."""
    if lu.is_cuda:
        from conflux_tpu_torch.ops import cuda_trsm

        return cuda_trsm.solve_unit_lower_t(Tpiv_t, lu)
    if lu.device.type == "cpu":
        return _pivot_solve_plain(Tpiv_t, lu, group)
    raise ValueError(f"no pivot-triangle solve for device {lu.device}")


def _gather_lanes(src: torch.Tensor, piv: torch.Tensor,
                  ok: torch.Tensor) -> torch.Tensor:
    """out[r, j] = src[r, piv[j]] where ok[j], else 0: a fresh contiguous
    [rows, n] tensor. The hand-written kernel (ops/cuda_lanes.py) for CUDA
    tensors, the plain version for CPU tensors; anything else raises."""
    global LANE_MOVES
    LANE_MOVES += 1
    if src.is_cuda:
        from conflux_tpu_torch.ops import cuda_lanes

        return cuda_lanes.gather_lanes(src, piv, ok)
    if src.device.type == "cpu":
        return torch.where(ok, src.index_select(1, piv), 0.0)
    raise ValueError(f"no pivot-lane gather for device {src.device}")


def _scatter_lanes(dst: torch.Tensor, piv: torch.Tensor, ok: torch.Tensor,
                   src: torch.Tensor) -> None:
    """dst[r, piv[j]] = src[r, j] for every j with ok[j], in place; an
    entry whose ok is False moves nothing (its lane may repeat another's).
    The hand-written kernel for CUDA tensors, the plain version for CPU
    tensors; anything else raises."""
    global LANE_MOVES
    LANE_MOVES += 1
    if dst.is_cuda:
        from conflux_tpu_torch.ops import cuda_lanes

        cuda_lanes.scatter_lanes_(dst, piv, ok, src)
    elif dst.device.type == "cpu":
        dst.index_copy_(1, piv[ok], src[:, ok])
    else:
        raise ValueError(f"no pivot-lane scatter for device {dst.device}")


def _deferred_update_t(Pt: torch.Tensor, piv: torch.Tensor,
                       ok: torch.Tensor, availf: torch.Tensor, r0: int,
                       r1: int, r2: int, forced: bool, finish: bool,
                       group: bool) -> None:
    """Update Pt's rows [r1, r2) in place by its factored rows [r0, r1),
    whose pivot lanes are piv[r0:r1] (ok: selected). The pivot lanes of
    rows [r0, r2) are read in one move (entries not ok read 0); forced
    pivots are the lanes r0..r1 themselves, so a slice serves there."""
    w = r1 - r0
    piv, ok = piv[r0:r1], ok[r0:r1]
    if forced:
        G = torch.where(ok, Pt[r0:r2, r0:r1], 0.0)
    else:
        G = _gather_lanes(Pt[r0:r2], piv, ok)                     # [r2-r0, w]
    # G[:w].T is the pivot rows' merged factor, column-major
    U12t = _pivot_solve_t(G[w:], G[:w].T, group)
    Lmul_t = torch.where(availf > 0, Pt[r0:r1], 0.0)              # [w, m]
    T_new = Pt[r1:r2] - U12t @ Lmul_t
    if forced:
        # keep the forced pivot lanes exact
        T_new[:, r0:r1] = U12t
    elif finish:
        _scatter_lanes(T_new, piv, ok, U12t)
    Pt[r1:r2] = T_new


def _lu_select_loop_t(panel: torch.Tensor, active: torch.Tensor, npiv: int,
                      forced: bool, block: int | None = None,
                      finish: bool = False):
    """Transposed two-level blocked elimination loop. panel [m, n] with
    n == npiv; active [m] bool. Returns (piv [npiv] i64, ok [npiv] bool,
    Pt [npiv, m]) where Pt's rows are the eliminated panel COLUMNS and
    non-pivot lanes hold their multipliers. With finish=False pivot lanes
    may be stale beyond their own block; with finish=True (or forced) Pt's
    pivot lane p_j holds the full merged-factor row lu[j, :]."""
    n = panel.shape[1]
    if n != npiv:
        raise ValueError(f"panel width {n} must equal npiv {npiv}")
    block = block or _BLOCK
    group = max(_GROUP, block)
    dev, dt = panel.device, panel.dtype

    availf = active.to(dt)[None, :]
    # Pt is a fresh copy, updated block by block in place
    Pt = panel.T.contiguous()
    piv = torch.zeros(npiv, dtype=torch.int64, device=dev)
    ok = torch.zeros(npiv, dtype=torch.bool, device=dev)

    for g0 in range(0, npiv, group):
        g1 = min(g0 + group, npiv)
        for b0 in range(g0, g1, block):
            b1 = min(b0 + block, g1)
            Bt2, availf, pivw, okb = _rank1_dispatch(
                Pt[b0:b1], availf, b0, forced, finish)
            piv[b0:b1] = pivw
            ok[b0:b1] = okb
            Pt[b0:b1] = Bt2
            if b1 < g1:
                # inner deferred update: only the group's remaining rows
                _deferred_update_t(Pt, piv, ok, availf, b0, b1, g1, forced,
                                   finish, group=False)
        if g1 < npiv:
            # outer K = g1-g0 update of everything beyond the group
            _deferred_update_t(Pt, piv, ok, availf, g0, g1, npiv, forced,
                               finish, group=True)
    return piv, ok, Pt


def _pivot_factors(panel: torch.Tensor, piv: torch.Tensor, npiv: int,
                   block: int | None = None) -> torch.Tensor:
    """Merged L\\U factors of the selected rows, recomputed by a forced
    (in-order) elimination of the gathered pivot rows: an LU without
    pivoting of panel[piv]."""
    tile = panel[piv]                                             # [npiv, npiv]
    _, _, Qt = _lu_select_loop_t(
        tile, torch.ones(npiv, dtype=torch.bool, device=panel.device), npiv,
        forced=True, block=block)
    return Qt.T


def _select_impl(panel, active, npiv: int, block: int, merged: bool = True):
    piv, ok, Pt = _lu_select_loop_t(panel, active, npiv, forced=False,
                                    block=block, finish=not merged)
    lu = _pivot_factors(panel, piv, npiv, block) if merged else None
    return piv, ok, Pt, lu


def factor_panel(panel: torch.Tensor, active: torch.Tensor, npiv: int,
                 block: int | None = None):
    """Full panel factorization: returns (piv, ok, M [m, n]) where M's
    non-pivot rows hold their multipliers and M's pivot rows hold the
    merged L\\U factors of the selected rows. With `active` all True the
    pivots are distinct."""
    piv, ok, Pt, lu = _select_impl(panel, active, npiv, block or _BLOCK)
    M = Pt.T.contiguous()
    M[piv] = lu                     # refresh the stale pivot rows in place
    return piv, ok, M


def factor_panel_raw(panel: torch.Tensor, active: torch.Tensor, npiv: int,
                     block: int | None = None, merged: bool = True):
    """factor_panel without the pivot-row refresh: returns (piv, ok, Mraw,
    lu). merged=True: Mraw's pivot rows are stale and `lu` holds the merged
    factor of the selected rows. merged=False: lu is None and Mraw[piv][j]
    is the full merged-factor row lu[j, :] (the elimination finishes the
    pivot lanes). Mraw is a transposed view of the eliminated panel."""
    piv, ok, Pt, lu = _select_impl(panel, active, npiv, block or _BLOCK,
                                   merged)
    return piv, ok, Pt.T, lu


def select_pivots(panel: torch.Tensor, active: torch.Tensor, npiv: int,
                  block: int | None = None):
    """Pick `npiv` rows of `panel` by partial pivoting. Returns (piv [npiv]
    i64 in pivot order, ok [npiv] bool — False where fewer than npiv valid
    rows existed, lu [npiv, npiv] merged L\\U with panel[piv] == L @ U)."""
    piv, ok, _, lu = _select_impl(panel, active, npiv, block or _BLOCK)
    return piv, ok, lu


def lu_nopivot(tile: torch.Tensor) -> torch.Tensor:
    """In-order LU of a square tile without pivoting (merged L\\U)."""
    n = tile.shape[0]
    _, _, Qt = _lu_select_loop_t(
        tile, torch.ones(n, dtype=torch.bool, device=tile.device), n,
        forced=True)
    return Qt.T
