"""The panel gather-and-reorder the rank programs share.

PyTorch counterpart of `conflux_tpu/ops/collect.py`: the reference's
`MPI_Iscatterv` panel distribution over `jk_comm`/`ik_comm`
(conflux_opt.hpp:1424-1434; Cholesky.cpp:459-481) as an all_gather over
axis 'x', a reorder into global-tile order and the selection of the tiles
this rank's local columns need.
"""

from __future__ import annotations

import torch


def panel_rows_for_columns(comm, Lb: torch.Tensor, v: int, Px: int, Py: int,
                           pj: int, ntl: int, base_row_tile: int = 0,
                           base_col_tile: int = 0) -> torch.Tensor:
    """Give this rank the panel tiles its local COLUMN tiles correspond to.

    Lb [mtl*v, w]: a column panel (any width w, e.g. the per-layer
    l = ceil(v/Pz) slice), the same on every rank of a 'y' row, holding
    local row tiles (base_row_tile + li)*Px + pi. Returns [ntl, v, w]:
    tile j for each local column tile lj, j = (base_col_tile + lj)*Py + pj.
    Out-of-window indices (dead tiles) are clipped; callers mask them."""
    mtl = Lb.shape[0] // v
    w = Lb.shape[1]
    lall = comm.all_gather(Lb, "x")                  # [Px, mtl*v, w]
    # entry (p, li) is global tile (base_row_tile + li)*Px + p: reorder so
    # axis 0 is the global tile index relative to base_row_tile*Px
    T = lall.reshape(Px, mtl, v, w).transpose(0, 1).reshape(mtl * Px, v, w)
    jidx = ((base_col_tile + torch.arange(ntl, device=Lb.device)) * Py + pj
            - base_row_tile * Px)
    return T[jidx.clamp(0, T.shape[0] - 1)]
