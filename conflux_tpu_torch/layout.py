"""Block-cyclic layout algebra and the (un)distribution of a matrix.

PyTorch counterpart of `conflux_tpu/layout.py`: the index maps
(conflux_opt.cpp:19-98), the butterfly partner map and the `BlockCyclic`
descriptor are copies. Storage convention, as in the JAX package: rank
(pi, pj, pz) holds the local block G[pz, pi*Ml:(pi+1)*Ml, pj*Nl:(pj+1)*Nl]
of the cyclic-permuted global array, [Ml, Nl] in row-major local tiles:
local row li*v + r is global row (li*Px + pi)*v + r. Every entry of the
matrix is a sum over the z layers; layer 0 carries the data at
distribution and the other layers carry zeros (lu_params.hpp:149-155).
Here each rank holds only its own block, as a tensor on its device, and
`retile` / `redistribute` move a matrix between two descriptors by one
all-to-all over the world.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch

from conflux_tpu_torch.comm import coords_of, rank_of
from conflux_tpu_torch.errors import ConfluxError, ErrorCode
from conflux_tpu_torch.grid import Grid


def l2g(p, l, stride):
    """Local tile index -> global tile index (conflux_opt.cpp:19-21)."""
    return l * stride + p


def g2l(g, stride):
    """Global tile index -> (owner, local tile index) (conflux_opt.cpp:23-27)."""
    return g % stride, g // stride


def g2l_row(grow, Px, v):
    """Global row -> (owner pi, local row within the [Ml] no-tile local
    frame), the row arithmetic of `g2lnoTile` (conflux_opt.cpp:74-98)."""
    gt = grow // v
    pown = gt % Px
    lt = gt // Px
    return pown, lt * v + grow % v


def local_row_to_global(pi: int, Px: int, v: int, Ml: int,
                        device=None) -> torch.Tensor:
    """int64 global row index of each of the Ml local rows of device row
    pi (also serves columns: local_row_to_global(pj, Py, v, Nl))."""
    lr = torch.arange(Ml, device=device)
    return ((lr // v) * Px + pi) * v + lr % v


def local_tile_to_global(p: int, P: int, v: int, L: int,
                         device=None) -> torch.Tensor:
    """int64 global TILE index of each of the L local rows (or columns)
    of device p."""
    return (torch.arange(L, device=device) // v) * P + p


def flipbit(n, k):
    """XOR bit k — butterfly partner map (conflux_opt.cpp:55-57)."""
    return n ^ (1 << k)


def butterfly_pair(pi: int, r: int, Px: int) -> int:
    """Partner of rank pi in butterfly round r for arbitrary Px
    (`conflux::butterfly_pair`, conflux_opt.cpp:59-72): non-power-of-two
    ranks fold the out-of-range partner back into the grid."""
    src = flipbit(pi, r)
    if src >= Px:
        if r == 0:
            src = pi
        else:
            src = flipbit(src, r - 1)
            if src >= Px:
                src = Px - 1
    return src


@dataclasses.dataclass(frozen=True, eq=False)
class BlockCyclic:
    """Block-cyclic descriptor (the `lu_params` geometry fields,
    lu_params.hpp:67-82)."""

    M: int          # padded global rows
    N: int          # padded global cols
    v: int          # tile size
    grid: Grid

    @staticmethod
    def create(M: int, N: int, v: int, grid: Grid) -> "BlockCyclic":
        """Pad M, N up to v*Px resp. v*Py multiples (lu_params.hpp:67-71).
        A square input stays square: both dims pad to the lcm of v*Px and
        v*Py. A tall input keeps a spare padding row for every padding
        column, so identity padding keeps it full column rank."""
        if v <= 0:
            raise ConfluxError(ErrorCode.INVALID_TILE,
                               f"tile size v={v} must be positive")
        if M == N:
            step = math.lcm(v * grid.Px, v * grid.Py)
            mp = np_ = step * (-(-N // step))
        else:
            mp = v * grid.Px * (-(-M // (v * grid.Px)))
            np_ = v * grid.Py * (-(-N // (v * grid.Py)))
            if M > N:
                need = max(np_, M + (np_ - N))
                mp = max(mp, v * grid.Px * (-(-need // (v * grid.Px))))
        return BlockCyclic(mp, np_, v, grid)

    @property
    def Mt(self) -> int:
        return self.M // self.v

    @property
    def Nt(self) -> int:
        return self.N // self.v

    @property
    def Mtl(self) -> int:  # local tile rows (tA11x in the reference)
        return self.Mt // self.grid.Px

    @property
    def Ntl(self) -> int:  # local tile cols (tA11y)
        return self.Nt // self.grid.Py

    @property
    def Ml(self) -> int:
        return self.Mtl * self.v

    @property
    def Nl(self) -> int:
        return self.Ntl * self.v

    @property
    def nlayr(self) -> int:
        """Per-z-layer slice of the update rank: ceil(v/Pz) (lu_params.hpp:73)."""
        return -(-self.v // self.grid.Pz)

    def global_shape(self) -> Tuple[int, int, int]:
        return (self.grid.Pz, self.grid.Px * self.Ml, self.grid.Py * self.Nl)


def pad_like(A, desc: BlockCyclic):
    """The dense padded matrix `distribute(A, desc)` factorizes: A in the
    top-left corner, ones on the trailing diagonal, zeros elsewhere (numpy
    in, numpy out; a tensor in, a tensor on its device out). Use it as the
    ground truth of a padded LU: pivoting may interleave padding rows, so
    its factors cannot be cropped back to A's shape."""
    if tuple(A.shape) == (desc.M, desc.N):
        return A
    m, n = A.shape
    if m > desc.M or n > desc.N:
        raise ConfluxError(ErrorCode.LAYOUT_MISMATCH,
                           f"matrix {tuple(A.shape)} larger than descriptor "
                           f"{(desc.M, desc.N)}")
    k = min(desc.M - m, desc.N - n)
    if isinstance(A, torch.Tensor):
        out = torch.zeros((desc.M, desc.N), dtype=A.dtype, device=A.device)
        idx = torch.arange(k, device=A.device)
    else:
        out = np.zeros((desc.M, desc.N), dtype=np.asarray(A).dtype)
        idx = np.arange(k)
    out[:m, :n] = A
    out[m + idx, n + idx] = 1
    return out


def distribute(A, desc: BlockCyclic):
    """This rank's [Ml, Nl] block of a dense [M, N] matrix (numpy or a
    tensor, the whole matrix on every rank; padded with `pad_like` when
    smaller than the descriptor), as a tensor on the grid's device: layer
    0 carries the data, the other z layers zeros. None on an idle rank."""
    g = desc.grid
    if g.idle:
        return None
    A = pad_like(A, desc)
    if not isinstance(A, torch.Tensor):
        A = torch.from_numpy(np.ascontiguousarray(A))
    if g.pz:
        return torch.zeros((desc.Ml, desc.Nl), dtype=A.dtype,
                           device=g.device)
    v = desc.v
    A6 = A.reshape(desc.Mtl, g.Px, v, desc.Ntl, g.Py, v)
    blk = A6[:, g.pi, :, :, g.pj, :].reshape(desc.Ml, desc.Nl)
    return blk.to(g.device).contiguous()


def undistribute(G: torch.Tensor, desc: BlockCyclic, root: int = 0):
    """Inverse of `distribute`: every rank's block is gathered to grid rank
    `root`, which sums the z layers and undoes the cyclic permutation.
    Returns the dense [M, N] tensor on `root`, None on the other ranks.
    Every rank of the grid must call it."""
    g = desc.grid
    if g.idle:
        return None
    if g.P == 1:
        return G.clone()
    blocks = g.comm.gather(G, root)
    if blocks is None:
        return None
    v = desc.v
    B = blocks.reshape(g.Px, g.Py, g.Pz, desc.Mtl, v, desc.Ntl, v).sum(dim=2)
    # B[pi, pj, li, r, lj, c] is global entry ((li*Px + pi)*v + r,
    # (lj*Py + pj)*v + c)
    return B.permute(2, 0, 3, 4, 1, 5).reshape(desc.M, desc.N).contiguous()


def _moves(P_src: int, v_src: int, L_src: int, P_dst: int, v_dst: int,
           device):
    """For each source coordinate p along one axis, two [L_src] tensors:
    the destination coordinate of each of p's local rows (or columns) and
    its local index there."""
    out = []
    for p in range(P_src):
        glob = local_row_to_global(p, P_src, v_src, L_src, device)
        tile = glob // v_dst
        out.append((tile % P_dst, (tile // P_dst) * v_dst + glob % v_dst))
    return out


def retile(G, src: BlockCyclic, dst: BlockCyclic,
           dtype: torch.dtype = torch.float32):
    """Move a distributed matrix from descriptor `src` to `dst` over the
    same world: this rank's block of the same matrix under `dst` (layer 0
    carries the data, the other layers zeros), None where `dst` leaves the
    rank idle. The descriptors may differ in tile size and in the grid's
    (Px, Py, Pz); the z-partials of `src` are summed on arrival. COSTA's
    grid2grid transform between two CONFLUX layouts
    (src/conflux/lu/layout.cpp), as one all-to-all over the world
    (`comm.Comm.all_to_all`): every rank sends each destination rank the
    entries it holds of that rank's block, and no rank ever holds the
    whole matrix. Every rank of the world must call it, idle ones too
    (G None there). The data moves in G's dtype; a rank idle in `src`
    holds no block to read it from and takes `dtype`, which must then be
    the matrix's. Raises LAYOUT_MISMATCH on different global shapes."""
    if (src.M, src.N) != (dst.M, dst.N):
        raise ConfluxError(ErrorCode.LAYOUT_MISMATCH,
                           f"retile requires identical global shapes, got "
                           f"{(src.M, src.N)} and {(dst.M, dst.N)}")
    gs, gd = src.grid, dst.grid
    if not gs.idle and tuple(G.shape) != (src.Ml, src.Nl):
        raise ConfluxError(ErrorCode.LAYOUT_MISMATCH,
                           f"block {tuple(G.shape)} is not the source "
                           f"descriptor's {(src.Ml, src.Nl)}")
    comm = gs.comm
    dev = gd.device if G is None else G.device
    dtype = dtype if G is None else G.dtype
    rows = _moves(gs.Px, src.v, src.Ml, gd.Px, dst.v, dev)
    cols = _moves(gs.Py, src.v, src.Nl, gd.Py, dst.v, dev)
    world = comm.world_size()
    dst_ranks = {rank_of((a, b, 0), (gd.Px, gd.Py, gd.Pz)): (a, b)
                 for a in range(gd.Px) for b in range(gd.Py)}

    # what this rank sends: for destination rank d = (a, b, 0), the
    # entries of its block whose rows go to row a and columns to column b
    chunks, in_splits = [], [0] * world
    if not gs.idle:
        rown, _ = rows[gs.pi]
        coln, _ = cols[gs.pj]
        for d, (a, b) in sorted(dst_ranks.items()):
            blk = G[rown == a][:, coln == b]
            chunks.append(blk.reshape(-1))
            in_splits[d] = blk.numel()
    # a rank idle in `src` sends nothing, in the matrix's dtype (`dtype`,
    # which it cannot read off a block it does not hold)
    send = (torch.cat(chunks) if chunks
            else torch.zeros(0, dtype=dtype, device=dev))

    # what this rank receives: from each source rank s = (p, q, z), the
    # entries whose destination is this rank, in the sender's order
    out_splits, places = [0] * world, []
    if not gd.idle and gd.pz == 0:
        for s in range(gs.P):
            p, q, _ = coords_of(s, (gs.Px, gs.Py, gs.Pz))
            rown, rloc = rows[p]
            coln, cloc = cols[q]
            rl, cl = rloc[rown == gd.pi], cloc[coln == gd.pj]
            out_splits[s] = rl.numel() * cl.numel()
            places.append((s, rl, cl))
    recv = comm.all_to_all(send, in_splits, out_splits)
    if gd.idle:
        return None
    out = torch.zeros((dst.Ml, dst.Nl), dtype=recv.dtype, device=dev)
    offs = [0]
    for n in out_splits:
        offs.append(offs[-1] + n)
    for s, rl, cl in places:
        if rl.numel() and cl.numel():
            # z-partials of one entry arrive from ranks in ascending pz
            out.index_put_((rl[:, None], cl[None, :]),
                           recv[offs[s]:offs[s + 1]].view(rl.numel(),
                                                           cl.numel()),
                           accumulate=True)
    return out


def redistribute(G, src: BlockCyclic, dst: BlockCyclic,
                 dtype: torch.dtype = torch.float32):
    """Move a distributed matrix onto a descriptor on another grid of the
    same world, for example from (2, 2, 2) to (2, 2, 1) with ranks 4-7
    idle. The JAX package's `redistribute(X, sharding)` is a device_put
    onto another sharding; the port has no sharding object, so the
    destination is a `BlockCyclic` and the move is `retile`'s all-to-all,
    whose contract it keeps."""
    return retile(G, src, dst, dtype)
