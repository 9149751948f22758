"""The communication-volume model of the 2.5D LU rank programs.

A copy of the numpy model part of `conflux_tpu/spec.py` (:37-85, :209-281):
`CommVolume`, the ring-volume helpers and `model_comm_volume`, which
`dispatch._lu_crout_grid_ok` prices the LU variants with. Volumes are
elements moved, summed over all ranks, under a bandwidth-optimal ring
model: a psum of E elements over g ranks moves 2 E (g - 1) per group, an
all_gather E (g - 1) g, a tiled psum_scatter E (g - 1), a ppermute E per
(src, dst) pair. The serial simulators stay in the JAX package; the
port's tests hold the collectives its rank programs record
(`comm.Comm.record`) to them.
"""

from __future__ import annotations

import dataclasses
from collections import Counter

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
