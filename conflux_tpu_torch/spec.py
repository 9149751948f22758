"""Executable specification: the serial numpy simulation of the
distributed tournament LU and the communication-volume models of the 2.5D
rank programs.

A copy of `conflux_tpu/spec.py`, which is numpy only: the masked
partial-pivoting selection and the butterfly tournament simulated rank by
rank (`select_pivots_np`, `tournament_np`, `tournament_lu_np`), the LU
model `model_comm_volume`, which `dispatch._lu_crout_grid_ok` prices the
LU variants with, and the Cholesky model `model_cholesky_comm_volume`.
Volumes are elements moved, summed over all ranks, under a
bandwidth-optimal ring model: a psum of E elements over g ranks moves
2 E (g - 1) per group, an all_gather E (g - 1) g, a tiled psum_scatter
E (g - 1), a ppermute E per (src, dst) pair. The port's tests hold the
collectives its rank programs record (`comm.Comm.record`) to them.

The models count the fused-panel crout's [v, v] lu00 psum over 'y'
(`pivot_bcast_y`, Px == 1) for every storage dtype; the JAX rank program
skips it under bf16 storage, which the port does not take yet (a known
over-count of the reference, kept as it is).
"""

from __future__ import annotations

import dataclasses
from collections import Counter
from typing import Tuple

import numpy as np

from conflux_tpu_torch.layout import butterfly_pair


@dataclasses.dataclass
class CommVolume:
    """Per-collective communication volumes (elements moved, summed over all
    ranks) for one factorization."""

    psum_z: float = 0.0          # step-0 lazy z-reduction of the panel column
    tournament_x: float = 0.0    # butterfly candidate exchange over 'x'
    pivot_bcast_y: float = 0.0   # win_idx + lu00 broadcast over 'y'
    row_gather_xz: float = 0.0   # pivot-row gather psum over ('x','z')
    panel_slice_y: float = 0.0   # per-layer L10 slice broadcast over 'y'
    rebalance_x: float = 0.0     # row-frontier rebalance (cnt psum +
    #                              gri/slab psum_scatter over 'x')
    # crout (left-looking) variant classes
    panel_asm_yz: float = 0.0    # fused raw-partials + L@U correction psum
    #                              of the panel column over ('y','z')
    uslab_y: float = 0.0         # panel-column U slab psum over 'y'
    uslab_ag_x: float = 0.0      # panel-column U slab all_gather over 'x'
    lpiv_ag_y: float = 0.0       # winners' L history all_gather over 'y'
    u12_corr_x: float = 0.0      # U12 big-K correction psum over 'x'
    rounds_x: int = 0            # number of butterfly rounds executed

    def total(self) -> float:
        return (self.psum_z + self.tournament_x + self.pivot_bcast_y
                + self.row_gather_xz + self.panel_slice_y
                + self.rebalance_x + self.panel_asm_yz + self.uslab_y
                + self.uslab_ag_x + self.lpiv_ag_y + self.u12_corr_x)

    def per_rank(self, P: int) -> float:
        return self.total() / P


def _ring_psum(E: int, g: int) -> float:
    """Total elements moved by one psum of E elements over g ranks."""
    return 2.0 * E * (g - 1)


def _ring_rs(E: int, g: int) -> float:
    """Total elements moved by one tiled psum_scatter of a per-rank
    [E]-element contribution over g ranks."""
    return float(E) * (g - 1)


def _ring_ag(E: int, g: int) -> float:
    """Total elements moved by one all_gather of a per-rank [E]-element
    shard over g ranks."""
    return float(E) * (g - 1) * g


def select_pivots_np(panel, active, npiv):
    """Masked partial-pivoting selection: the numpy twin of
    ops.panel.select_pivots. Returns (piv, ok, merged factor rows)."""
    M = panel.astype(np.float64).copy()
    m = M.shape[0]
    sel = np.zeros(m, bool)
    piv, ok = [], []
    for j in range(npiv):
        score = np.where(active & ~sel, np.abs(M[:, j]), -np.inf)
        p = int(np.argmax(score))
        piv.append(p)
        ok.append(bool(active[p] and not sel[p]))
        pv = M[p, j] if M[p, j] != 0 else 1.0
        mult = M[:, j] / pv
        elim = active & ~sel
        elim[p] = False
        M[elim, j + 1:] -= np.outer(mult[elim], M[p, j + 1:])
        M[elim, j] = mult[elim]
        sel[p] = True
    return np.array(piv), np.array(ok), M[np.array(piv)]


def _merge_np(a_vals, a_idx, b_vals, b_idx, v):
    """The tournament merge: the numpy twin of lu.p25d._merge_round."""
    vals = np.concatenate([a_vals, b_vals])
    idx = np.concatenate([a_idx, b_idx])
    piv, ok, lu = select_pivots_np(vals, idx >= 0, v)
    win_vals = np.where(ok[:, None], vals[piv], 0.0)
    win_idx = np.where(ok, idx[piv], -1)
    return win_vals, win_idx, lu


def tournament_np(cands, v: int, Px: int, comm: CommVolume,
                  replicas: int = 1):
    """Simulate the any-Px log-round butterfly (lu.p25d._tournament,
    'butterfly'): receive map `butterfly_pair` (conflux_opt.cpp:59-72),
    the lower origin's list first, and a self-receive round delivers an
    empty list.

    cands: {pi: (vals [v, v], idx [v])}. Returns (win_idx, lu00), the same
    on every rank (checked). `replicas`: how many grid columns and layers
    run the same exchange (the rank program runs it on every (y, z))."""
    if Px == 1:
        raise ValueError("tournament needs Px > 1")
    rounds = (Px - 1).bit_length()
    lu00 = {pi: None for pi in range(Px)}
    for r in range(rounds):
        src_of = [butterfly_pair(d, r, Px) for d in range(Px)]
        pairs = [(s, d) for d, s in enumerate(src_of) if s != d]
        cnt = Counter(s for s, _ in pairs)
        E = v * (v + 1)  # vals [v, v] + idx [v]
        for s, d in pairs:
            if cnt[s] == 1:
                comm.tournament_x += E * replicas            # ppermute pair
        for s in {s for s, _ in pairs if cnt[s] > 1}:
            comm.tournament_x += _ring_psum(E, Px) * replicas  # masked psum
        comm.rounds_x += 1
        nxt = {}
        for pi in range(Px):
            s = src_of[pi]
            if s == pi:  # self-receive: an empty list
                rv = np.zeros((v, v))
                ri = -np.ones(v, dtype=int)
            else:
                rv, ri = cands[s]
            ov, oi = cands[pi]
            if s > pi:
                a_vals, a_idx, b_vals, b_idx = ov, oi, rv, ri
            else:
                a_vals, a_idx, b_vals, b_idx = rv, ri, ov, oi
            wv, wi, lu = _merge_np(a_vals, a_idx, b_vals, b_idx, v)
            nxt[pi] = (wv, wi)
            lu00[pi] = lu
        cands = nxt
    win0 = cands[0][1]
    for pi in range(1, Px):
        if not np.array_equal(cands[pi][1], win0):
            raise AssertionError("the tournament did not give every rank "
                                 "the same winners")
        if not np.allclose(lu00[pi], lu00[0]):
            raise AssertionError("the merged factors differ between ranks")
    return win0, lu00[0]


def model_cholesky_comm_volume(
    N: int, v: int, Px: int, Py: int = 1, Pz: int = 1,
    variant: str = "rightlook",
) -> dict:
    """Closed-form total ring volumes (elements moved, summed over all
    ranks) of the 2.5D Cholesky rank programs, per collective class: the
    Cholesky sibling of model_comm_volume. 'rightlook' models the
    full-height (fori) schedule; programs that slice the live window move
    less. 'crout' models the left-looking program exactly."""
    Nt = N // v
    Ml = N // Px
    l = -(-v // Pz)
    out: dict = {}
    if variant == "crout":
        out = {"slab_xz": 0.0, "col_yz": 0.0, "a00_x": 0.0}
        for k in range(Nt):
            if k:
                out["slab_xz"] += (
                    2.0 * v * (-(-k // Py) * v) * (Px * Pz - 1) * Py)
            out["col_yz"] += (
                2.0 * (Ml - (k // Px) * v) * v * (Py * Pz - 1) * Px)
            out["a00_x"] += 2.0 * v * v * (Px - 1) * Py * Pz
    else:
        out = {
            "reduce_z": Nt * 2.0 * Ml * v * (Pz - 1) * Px * Py,
            "a00_xy": Nt * 2.0 * v * v * (Px * Py - 1) * Pz,
            "slice_y": Nt * 2.0 * Ml * l * (Py - 1) * Px * Pz,
            "panel_ag_x": Nt * float(Ml * l) * (Px - 1) * Px * Py * Pz,
        }
    out["total"] = sum(out.values())
    return out


def model_comm_volume(
    N: int, v: int, Px: int, Pz: int = 1, Py: int = 1,
    rowpart: int = 0, variant: str = "rightlook",
) -> CommVolume:
    """The communication-volume model of the LU rank programs at any size,
    in O(Nt): 'rightlook' (the right-looking programs) or 'crout' (the
    left-looking one), with a row rebalance every `rowpart` steps."""
    Nt = N // v
    l = -(-v // Pz)
    Ml = N // Px
    Nl = N // Py
    mr = Ml
    comm = CommVolume()
    crout = variant == "crout"
    rounds = (Px - 1).bit_length() if Px > 1 else 0
    # per-round ppermute/psum volume (butterfly_pair receive map)
    per_round = []
    for r in range(rounds):
        src_of = [butterfly_pair(d, r, Px) for d in range(Px)]
        pairs = [(s, d) for d, s in enumerate(src_of) if s != d]
        cnt = Counter(s for s, _ in pairs)
        E = v * (v + 1)
        vol = sum(E for s, _ in pairs if cnt[s] == 1)
        vol += sum(_ring_psum(E, Px)
                   for s in {s for s, _ in pairs if cnt[s] > 1})
        per_round.append(vol)
    for k in range(Nt):
        if crout:
            comm.panel_asm_yz += _ring_psum(mr * v, Py * Pz) * Px
            if k > 0:
                nmy = -(-k // Px)
                comm.uslab_y += _ring_psum(nmy * v * v, Py) * Px * Pz
                comm.uslab_ag_x += _ring_ag(nmy * v * v, Px) * Py * Pz
        else:
            comm.psum_z += _ring_psum(mr * v, Pz) * Px * Py
        if Px > 1:
            comm.tournament_x += sum(per_round) * Py * Pz
            comm.rounds_x += rounds
        if not crout:
            comm.pivot_bcast_y += _ring_psum(v * v + v, Py) * Px * Pz
        elif Px == 1:
            # fused-panel crout: the [v, v] lu00 replication over 'y'
            comm.pivot_bcast_y += _ring_psum(v * v, Py) * Px * Pz
        comm.row_gather_xz += _ring_psum(v * Nl, Px * Pz) * Py
        if crout and k > 0:
            nbf = -(-k // Py)
            nw = Nl - (k // Py) * v
            comm.lpiv_ag_y += _ring_ag(v * nbf * v, Py) * Px * Pz
            comm.u12_corr_x += _ring_psum(v * nw, Px) * Py * Pz
        if not crout:
            comm.panel_slice_y += _ring_psum(mr * l, Py) * Px * Pz
        if rowpart and (k + 1) % rowpart == 0 and k + 1 < Nt:
            live = N - (k + 1) * v
            Mlp = max(-(-v // 8) * 8, -(-live // Px // 8) * 8)
            if Mlp < mr:
                mr = Mlp
                if Px > 1:
                    T = Px * Mlp
                    comm.rebalance_x += (
                        _ring_psum(N, Px) + _ring_rs(T, Px)
                        + _ring_rs(T * Nl, Px)
                    ) * Py * Pz
    return comm


def tournament_lu_np(
    A: np.ndarray, v: int, Px: int, Pz: int = 1, Py: int = 1,
    rowpart: int = 0, variant: str = "rightlook",
) -> Tuple[np.ndarray, np.ndarray, CommVolume]:
    """Serial simulation of the distributed tournament-pivoted LU, in
    float64. Returns (F, the merged LU of P·A in pivot order, pivots, the
    comm volume). Rows are tile-cyclic over Px virtual rank rows and the
    butterfly merges in the rank program's order, so the pivots are
    lu_25d's (up to fp ties); Pz and Py change only the volumes (the
    arithmetic is replicated).

    rowpart > 0 models the row rebalance every `rowpart` steps
    (p25d._rebalance_rows): one count psum over 'x' and the psum_scatters
    of the global-row vector and the live rows, after which the panel
    reductions and L10 slice broadcasts move the smaller height.
    variant='crout' counts the left-looking program's collectives instead
    (the fused ('y', 'z') panel assembly, the U slab over 'y' and 'x', the
    winners' L history over 'y' and the U12 correction over 'x'; no pivot
    broadcast except the fused panel's lu00 at Px == 1, no L10 slices);
    its arithmetic is the same."""
    N = A.shape[0]
    Nt = N // v
    l = -(-v // Pz)  # nlayr = ceil(v/Pz), lu_params.hpp:73
    Ml = N // Px     # local rows per rank row
    Nl = N // Py     # local columns per rank column
    mr = Ml          # current working height (row frontier)
    M = A.astype(np.float64).copy()
    active = np.ones(N, bool)
    owner = (np.arange(N) // v) % Px
    pivots_all = []
    F = np.zeros_like(M)
    comm = CommVolume()
    crout = variant == "crout"
    for k in range(Nt):
        colk = M[:, k * v:(k + 1) * v]
        if crout:
            # the fused panel assembly, one [mr, v] psum over ('y', 'z');
            # the U slab (psum 'y' + all_gather 'x') of [nmy*v, v]
            comm.panel_asm_yz += _ring_psum(mr * v, Py * Pz) * Px
            if k > 0:
                nmy = -(-k // Px)
                comm.uslab_y += _ring_psum(nmy * v * v, Py) * Px * Pz
                comm.uslab_ag_x += _ring_ag(nmy * v * v, Px) * Py * Pz
        else:
            # step 0: the lazy z-reduction of the panel column
            comm.psum_z += _ring_psum(mr * v, Pz) * Px * Py
        cands = {}
        for pi in range(Px):
            rows = np.where(owner == pi)[0]
            piv, ok, lu = select_pivots_np(colk[rows], active[rows], v)
            idx = np.where(ok, rows[piv], -1)
            vals = np.where(ok[:, None], colk[rows][piv], 0.0)
            cands[pi] = (vals, idx)
            if Px == 1:
                lu00 = lu
                win = idx
        if Px > 1:
            win, lu00 = tournament_np(cands, v, Px, comm, replicas=Py * Pz)
        if not crout:
            # win_idx + lu00 broadcast over 'y'
            comm.pivot_bcast_y += _ring_psum(v * v + v, Py) * Px * Pz
        elif Px == 1:
            # fused-panel crout: lu00 replicated by one [v, v] psum over 'y'
            comm.pivot_bcast_y += _ring_psum(v * v, Py) * Px * Pz
        pivots_all.extend(win.tolist())

        L00 = np.tril(lu00[:, :v], -1) + np.eye(v)
        U00 = np.triu(lu00[:, :v])
        dU = np.diag(U00).copy()
        U00[np.diag_indices(v)] = np.where(dU == 0, 1, dU)
        raw = M[win]
        # the pivot rows: a psum of [v, Nl] over ('x', 'z')
        comm.row_gather_xz += _ring_psum(v * Nl, Px * Pz) * Py
        if crout and k > 0:
            # the winners' L history over 'y' and the U12 correction over 'x'
            nbf = -(-k // Py)
            nw = Nl - (k // Py) * v
            comm.lpiv_ag_y += _ring_ag(v * nbf * v, Py) * Px * Pz
            comm.u12_corr_x += _ring_psum(v * nw, Px) * Py * Pz
        Y = np.linalg.solve(L00, raw)
        F[k * v:(k + 1) * v, :k * v] = raw[:, :k * v]
        F[k * v:(k + 1) * v, k * v:(k + 1) * v] = lu00[:, :v]
        F[k * v:(k + 1) * v, (k + 1) * v:] = Y[:, (k + 1) * v:]
        active[win] = False
        L10 = colk @ np.linalg.inv(U00)
        if not crout:
            # the per-layer L10 slice: a psum of [mr, l] over 'y'
            comm.panel_slice_y += _ring_psum(mr * l, Py) * Px * Pz
        rest = slice((k + 1) * v, N)
        M[active, rest] -= L10[active] @ Y[:, rest]
        M[active, k * v:(k + 1) * v] = L10[active]
        if rowpart and (k + 1) % rowpart == 0 and k + 1 < Nt:
            live = N - (k + 1) * v
            Mlp = max(-(-v // 8) * 8, -(-live // Px // 8) * 8)
            if Mlp < mr:
                mr = Mlp
                if Px > 1:
                    T = Px * Mlp
                    comm.rebalance_x += (
                        _ring_psum(N, Px)
                        + _ring_rs(T, Px)
                        + _ring_rs(T * Nl, Px)
                    ) * Py * Pz
    return F, np.array(pivots_all), comm
