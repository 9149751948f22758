"""Distributed complex 2.5D LU with tournament pivoting, one process per
rank.

PyTorch counterpart of `conflux_tpu/lu/cp25d.py`: the right-looking rank
program of lu/p25d with every real kernel swapped for its complex twin
from ops/cplx.py (complex64, and complex128 as the JAX package's x64
mode), as the JAX module reuses lu/p25d's machinery:

  * panel factorization and tournament merges: `cpanel_factor` (cabs1
    scoring) through lu/p25d's butterfly exchange (`_round_exchange`,
    `_merge_round`); the collectives move the complex blocks as they are
    (comm.py);
  * TRSMs: `ctrsm_left_lower_unit` / `ctrsm_right_upper`;
  * trailing update: `cschur_dot` (real products of the parts), each z
    layer on its l = ceil(v/Pz) slice.

The z-partial invariant carries over: complex blocks are z-partial sums,
the factor lives on layer 0. Tournament pivoting only, no row rebalance
(the JAX fori program's layout), square or tall (M >= N, through
lu/p25d's `_tall_tail`). No Pallas kernel exists on this path in the JAX
package, so none does here.
"""

from __future__ import annotations

import torch

from conflux_tpu_torch.errors import ConfluxError, ErrorCode
from conflux_tpu_torch.layout import (
    BlockCyclic,
    local_row_to_global,
    local_tile_to_global,
)
from conflux_tpu_torch.lu.csingle import check_complex
from conflux_tpu_torch.lu.p25d import (
    _find_local_rows,
    _merge_round,
    _pivot_blocks,
    _round_exchange,
    _tall_tail,
)
from conflux_tpu_torch.ops.cplx import (
    cpanel_factor,
    cschur_dot,
    ctrsm_left_lower_unit,
    ctrsm_right_upper,
)
from conflux_tpu_torch.precision import ieee_fp32


def cselect_pivots(panel, active, npiv: int):
    """Complex twin of ops.panel.select_pivots: (piv, ok, lu) with lu the
    merged L\\U rows of the winners (cpanel_factor leaves them in
    place)."""
    piv, ok, M = cpanel_factor(panel, active, npiv)
    return piv, ok, M[piv]


def _ctournament(comm, colk, active, gri, v: int, Px: int):
    """The v pivot rows of the complex step panel chosen over 'x': the
    butterfly of lu/p25d._tournament with cselect_pivots as the round
    kernel (every round forms its merged factor, as in the JAX module).
    Returns (win_idx [v] global rows, lu00 [v, v])."""
    piv, ok, lu = cselect_pivots(colk, active, v)
    cand_vals = torch.where(ok[:, None], colk[piv], 0)
    cand_idx = torch.where(ok, gri[piv], -1)
    if Px == 1:
        return cand_idx, lu
    pi = comm.coord("x")
    lu00 = lu
    for r in range((Px - 1).bit_length()):
        (recv_vals, recv_idx), src_of = _round_exchange(
            comm, pi, (cand_vals, cand_idx), r, Px)
        src = src_of[pi]
        if src == pi:
            # a self-receive round (non-power-of-two Px) merges an empty
            # list, not a duplicate
            recv_vals = torch.zeros_like(recv_vals)
            recv_idx = torch.full_like(recv_idx, -1)
        if src > pi:
            a, b = (cand_vals, cand_idx), (recv_vals, recv_idx)
        else:
            a, b = (recv_vals, recv_idx), (cand_vals, cand_idx)
        cand_vals, cand_idx, lu00 = _merge_round(*a, *b, v, True,
                                                 select=cselect_pivots)
    return cand_idx, lu00


def _local_clu_25d(desc: BlockCyclic, method: str, G: torch.Tensor):
    """The complex rank program on this rank's block G (not modified):
    (F, pivots) as lu/p25d._local_lu_25d, step k on the live column
    window [c0:]."""
    g = desc.grid
    comm = g.comm
    v, Px, Py, Pz = desc.v, g.Px, g.Py, g.Pz
    Nl = desc.Nl
    l = desc.nlayr
    kpad = Pz * l - v
    pi, pj, pz = g.pi, g.pj, g.pz
    dev = G.device
    gri = local_row_to_global(pi, Px, v, desc.Ml, dev)
    gt_col = local_tile_to_global(pj, Py, v, Nl, dev)
    A = G.clone()
    F = torch.zeros_like(A)
    active = torch.ones(desc.Ml, dtype=torch.bool, device=dev)
    pivots = torch.zeros(desc.M, dtype=torch.int64, device=dev)
    for k in range(desc.Nt):
        mr = A.shape[0]
        c0 = (k // Py) * v
        r0f = (k // Px) * v
        own_y = pj == k % Py
        own_x = pi == k % Px

        # step 0: lazy z-reduction (a complex psum adds the parts)
        colk = comm.psum(A[:, c0:c0 + v], "z")
        # step 1: tournament over 'x' on the owner column, bcast over 'y'
        win_idx, lu00 = _ctournament(comm, colk, active, gri, v, Px)
        win_idx = comm.psum(win_idx if own_y else torch.zeros_like(win_idx),
                            "y")
        lu00 = comm.psum(lu00 if own_y else torch.zeros_like(lu00), "y")
        pivots[k * v:(k + 1) * v] = win_idx
        mine, lr = _find_local_rows(gri, win_idx)
        active &= ~(gri[:, None] == win_idx[None, :]).any(dim=1)

        # steps 2+3: the full-width pivot rows on every rank
        raw = comm.psum(torch.where(mine[:, None], A[lr], 0), ("x", "z"))

        # steps 4+5: TRSMs and the factor and panel writes
        L00, U00 = _pivot_blocks(lu00)
        Y = ctrsm_left_lower_unit(L00, raw[:, c0:])
        if own_x and pz == 0:
            F[r0f:r0f + v, :c0] = raw[:, :c0]
            F[r0f:r0f + v, c0:] = torch.where(gt_col[None, c0:] > k, Y,
                                              raw[:, c0:])
            if own_y:
                F[r0f:r0f + v, c0:c0 + v] = lu00
        L10 = torch.where(active[:, None], ctrsm_right_upper(colk, U00), 0)
        if own_y:
            A[:, c0:c0 + v] = L10 if pz == 0 else 0

        # step 6: split-K trailing update (layer pz takes its l slice)
        L10p = torch.nn.functional.pad(L10, (0, kpad)) if kpad else L10
        Lk = comm.psum(L10p[:, pz * l:(pz + 1) * l] if own_y
                       else L10.new_zeros((mr, l)), "y")
        Ymask = torch.where(gt_col[None, c0:] > k, Y, 0)
        if kpad:
            Ymask = torch.nn.functional.pad(Ymask, (0, 0, 0, kpad))
        Yk = Ymask[pz * l:(pz + 1) * l]
        upd = cschur_dot(Lk, Yk, method)
        A[:, c0:] -= torch.where(active[:, None], upd, 0)

    if desc.M > desc.N:
        F, pivots = _tall_tail(desc, comm, A, F, active, pivots, gri)
    return F, pivots


@ieee_fp32()
def clu_25d(G: torch.Tensor, desc: BlockCyclic, method: str = "4m"):
    """Distributed complex LU of this rank's [Ml, Nl] complex64 or
    complex128 block G of the z-partial layout: (F, pivots) with lu_25d's
    contract (the merged factor rows in pivot order on layer 0, the global
    pivot vector on every rank); (None, None) on an idle rank. Every rank
    of the grid must call it. `method` picks the complex product ('4m' or
    '3m', ops/cplx.cschur_dot)."""
    if desc.grid.idle:
        return None, None
    check_complex(G, "clu_25d")
    if desc.M < desc.N:
        raise ConfluxError(ErrorCode.INVALID_SHAPE,
                           "distributed LU requires M >= N (tall or square)")
    if tuple(G.shape) != (desc.Ml, desc.Nl):
        raise ConfluxError(ErrorCode.LAYOUT_MISMATCH,
                           f"block {tuple(G.shape)} is not the descriptor's "
                           f"{(desc.Ml, desc.Nl)}")
    return _local_clu_25d(desc, method, G)
