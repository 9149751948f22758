"""Processor-grid selection and the rank's place in the grid.

PyTorch counterpart of `conflux_tpu/grid.py`. The selection heuristics are
copies (lu_params::get_p_grid, lu_params.hpp:21-47; Cholesky.cpp:76-134;
python/settings.py:25-52). Where the JAX package builds one mesh with
named axes ('x', 'y', 'z') over all devices, each process here is one rank
of a torch.distributed world: `make_grid` places it at its (pi, pj, pz)
coordinates (rank = (pi * Py + pj) * Pz + pz, as the JAX mesh orders its
devices), on its device, with a `comm.Comm` holding one process group per
coset of each axis subset.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from conflux_tpu_torch.comm import Comm
from conflux_tpu_torch.errors import ConfluxError, ErrorCode


def _lcm(a: int, b: int) -> int:
    return abs(a * b) // math.gcd(a, b)


def choose_grid_lu(M: int, N: int, P: int) -> Tuple[int, int, int]:
    """Pick (Px, Py, Pz) for LU given matrix shape and device count
    (`lu_params::get_p_grid`, lu_params.hpp:21-47): a perfect square
    (p, p, 1); then (p, p, 2) when P/2 is a perfect square; otherwise a
    cube-root split scaled by the aspect ratio, sorted descending."""
    ratio = max(M, N) / min(M, N)
    p_sq = int(math.isqrt(int(P / ratio)))
    p_half_sq = int(math.isqrt(int(P / (2 * ratio))))
    if P == p_sq * p_sq:
        return (p_sq, p_sq, 1)
    if P >= 2 and p_half_sq * p_half_sq == P // 2 and P % 2 == 0:
        return (p_half_sq, p_half_sq, 2)
    p1 = max(1, int((P / ratio) ** (1.0 / 3.0)))
    px = p1
    py = max(1, int(ratio * p1))
    pz = max(1, P // (px * py))
    dims = sorted([px, py, pz], reverse=True)
    return (dims[0], dims[1], dims[2])


def choose_grid_cholesky(P: int, N: int) -> Tuple[int, int, int]:
    """Pick (Px, Py, Pz) for Cholesky: the special cases and the
    power-of-two default of `conflux::initialize` (Cholesky.cpp:76-114)."""
    if P == 8 and N < 16384:
        return (2, 2, 2)
    if P == 32 and N < 8192:
        return (4, 4, 2)
    if P == 128 and N <= 16384:
        return (8, 8, 2)
    if P == 512:
        return (16, 16, 2)
    pow2 = int(math.log2(P)) if P > 0 else 0
    px = (1 << (pow2 // 2)) * (1 if pow2 % 2 == 0 else 2)
    py = 1 << (pow2 // 2)
    return (px, py, 1)


def choose_tile_cholesky(N: int, grid: Tuple[int, int, int], P: int) -> int:
    """Tile size from the per-rank footprint N*N*Pz/P in millions of
    elements (Cholesky.cpp:116-134): v in {128, 256, 512, 1024}."""
    ratio = (float(N) * N * grid[2] / P) / 1e6
    if ratio < 2.5:
        return 128
    if ratio < 30:
        return 256
    if ratio < 250:
        return 512
    return 1024


def choose_decomposition(P: int) -> Tuple[int, int]:
    """(sqrtp1, c): 2D side length and replication factor minimizing the
    modeled cost 1/(ppp*c) over c <= (P+1)^(1/3) (`CalculateDecomposition`,
    python/settings.py:25-42)."""
    p13 = int(math.floor((P + 1) ** (1.0 / 3.0)))
    best_ppp = int(math.floor(math.sqrt(P)))
    best_c = 1
    best_cost = 1.0 / (best_ppp * best_c)
    for c in range(1, p13 + 1):
        ppp = int(math.floor(math.sqrt(P // c)))
        cost = 1.0 / (ppp * c)
        if cost < best_cost:
            best_cost, best_ppp, best_c = cost, ppp, c
    assert best_ppp * best_ppp * best_c <= P
    return best_ppp, best_c


def choose_parameters(inp_n: int, P: int) -> Tuple[int, int, int, int]:
    """(sqrtp1, c, v, N_padded) (`CalculateParameters`,
    python/settings.py:45-52): v = lcm(sqrtp1, c), N padded to v*sqrtp1."""
    sqrtp1, c = choose_decomposition(P)
    v = _lcm(sqrtp1, c)
    n_local_tiles = -(-inp_n // (v * sqrtp1))
    n = v * sqrtp1 * n_local_tiles
    return sqrtp1, c, v, n


@dataclasses.dataclass(frozen=True, eq=False)
class Grid:
    """This rank's view of a (Px, Py, Pz) processor grid.

    Axes: 'x' distributes tile rows, 'y' tile columns, and 'z' is the 2.5D
    replication axis (the reference's Pz / `k_comm`, lu_params.hpp:98-101).
    `rank` is None on a rank the grid leaves idle (the world has more
    ranks than the grid needs); the entry points return None there."""

    Px: int
    Py: int
    Pz: int
    rank: Optional[int]
    device: torch.device
    comm: Comm

    @property
    def P(self) -> int:
        return self.Px * self.Py * self.Pz

    @property
    def idle(self) -> bool:
        return self.rank is None

    @property
    def pi(self) -> int:
        return self.comm.coord("x")

    @property
    def pj(self) -> int:
        return self.comm.coord("y")

    @property
    def pz(self) -> int:
        return self.comm.coord("z")

    def __repr__(self) -> str:  # grid string parity with miniapp output
        return f"{self.Px}x{self.Py}x{self.Pz}"


def _default_device(rank: int) -> torch.device:
    """The card of this rank: card rank % device_count, or plain 'cuda'
    (which raises at first use) where torch sees no card."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return torch.device("cuda", rank % n) if n else torch.device("cuda")


def make_grid(
    shape: Optional[Tuple[int, int, int]] = None,
    *,
    device=None,
    M: Optional[int] = None,
    N: Optional[int] = None,
    algorithm: str = "lu",
) -> Grid:
    """Place this rank in a (Px, Py, Pz) grid over the torch.distributed
    world (a world of one without a process group).

    Every rank of the world must call it, with the same arguments: it
    creates the grid's process groups, a collective operation. shape None
    auto-selects like the reference miniapps (lu_params.hpp:21-47,
    Cholesky.cpp:76-114). Raises DEVICE_SHORTAGE when the world has fewer
    ranks than the grid needs, so a P > 1 grid needs an initialized
    process group (`launch.run_ranks`, torchrun); warns and leaves the
    extra ranks idle when it has more. device: this rank's device, the
    card unless the caller asks for the CPU."""
    import torch.distributed as dist

    from conflux_tpu_torch.launch import init_from_env

    init_from_env()
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if shape is None:
        n = N if N is not None else 4096
        m = M if M is not None else n
        if algorithm == "cholesky":
            shape = choose_grid_cholesky(world, n)
        else:
            shape = choose_grid_lu(m, n, world)
    px, py, pz = shape
    if min(shape) < 1:
        raise ConfluxError(ErrorCode.INVALID_GRID, f"grid {px}x{py}x{pz}")
    P = px * py * pz
    if P > world:
        raise ConfluxError(
            ErrorCode.DEVICE_SHORTAGE,
            f"grid {px}x{py}x{pz} needs {P} ranks, the world has {world} "
            "(start the ranks with launch.run_ranks or torchrun)")
    if P < world:
        import warnings

        warnings.warn(f"grid {px}x{py}x{pz} uses {P} of {world} ranks; "
                      f"{world - P} rank(s) idle", stacklevel=2)
    device = torch.device(device) if device is not None else \
        _default_device(rank)
    comm = Comm((px, py, pz), rank, device)
    return Grid(px, py, pz, rank if rank < P else None, device, comm)
