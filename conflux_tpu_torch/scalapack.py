"""ScaLAPACK-style entry points: pdgetrf and pdpotrf.

PyTorch counterpart of `conflux_tpu/scalapack.py`. The reference ships a
BLACS/ScaLAPACK bridge (examples/utils.hpp:38-240 and the COSTA
transforms of examples/conflux_miniapp.cpp:349-422) so that users of
block-cyclic ScaLAPACK layouts can call CONFLUX. These functions take a
dense matrix on every rank, pick a grid and a tile size by the
reference's rules when none is given, run the distributed factorization
and return a handle on this rank's block of the factor, with LAPACK-style
pivots. Every rank of the world calls them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from conflux_tpu_torch.cholesky.p25d import cholesky_25d
from conflux_tpu_torch.errors import ConfluxError, ErrorCode
from conflux_tpu_torch.grid import (
    Grid,
    choose_grid_cholesky,
    choose_grid_lu,
    choose_tile_cholesky,
    make_grid,
)
from conflux_tpu_torch.layout import BlockCyclic, distribute, undistribute
from conflux_tpu_torch.lu.p25d import lu_25d
from conflux_tpu_torch.native import perm_to_ipiv


@dataclass(frozen=True)
class Factorization:
    """This rank's handle on a distributed factor: its [Ml, Nl] block
    stays on its device until `dense` gathers the matrix."""

    data: Optional[torch.Tensor]     # this rank's block (None when idle)
    desc: BlockCyclic
    perm: Optional[torch.Tensor] = None  # LU only: slot -> original row

    def dense(self, root: int = 0):
        """The dense factor on grid rank `root`, None on the other ranks:
        `layout.undistribute`, a collective every rank calls."""
        return undistribute(self.data, self.desc, root)

    def ipiv(self) -> np.ndarray:
        """LAPACK-style sequential-swap pivot vector (1-based, like
        getrf's IPIV) of the permutation."""
        if self.perm is None:
            raise ConfluxError(ErrorCode.NOT_FACTORIZED,
                               "no pivots: not an LU factorization")
        return perm_to_ipiv(self.perm.cpu().numpy())


def _world_size() -> int:
    import torch.distributed as dist

    from conflux_tpu_torch.launch import init_from_env

    init_from_env()
    return dist.get_world_size() if dist.is_initialized() else 1


def pdgetrf(A, grid: Optional[Grid] = None, v: Optional[int] = None,
            pivoting: str = "tournament") -> Factorization:
    """Distributed LU with pivoting of a dense [M, N] matrix (numpy or a
    tensor, on every rank). grid None: `choose_grid_lu` over the world's
    ranks on each rank's card; v None: `choose_tile_cholesky`, as the JAX
    package picks it."""
    m, n = A.shape
    if grid is None:
        grid = make_grid(choose_grid_lu(m, n, _world_size()))
    if v is None:
        v = choose_tile_cholesky(n, (grid.Px, grid.Py, grid.Pz), grid.P)
    desc = BlockCyclic.create(m, n, v, grid)
    F, perm = lu_25d(distribute(A, desc), desc, pivoting)
    return Factorization(F, desc, perm)


def pdpotrf(A, grid: Optional[Grid] = None,
            v: Optional[int] = None) -> Factorization:
    """Distributed lower Cholesky of a dense SPD matrix (numpy or a
    tensor, on every rank); grid and v chosen as in `pdgetrf`, the grid by
    `choose_grid_cholesky`."""
    n = A.shape[0]
    if grid is None:
        grid = make_grid(choose_grid_cholesky(_world_size(), n))
    if v is None:
        v = choose_tile_cholesky(n, (grid.Px, grid.Py, grid.Pz), grid.P)
    desc = BlockCyclic.create(n, n, v, grid)
    return Factorization(cholesky_25d(distribute(A, desc), desc), desc)
