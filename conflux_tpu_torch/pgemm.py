"""Distributed matrix product (SUMMA) and the fully distributed residual
gates.

PyTorch counterpart of `conflux_tpu/pgemm.py`. The reference validates
with ScaLAPACK: COSTA moves the factors to a BLACS grid and two `pdgemm_`
calls form ||PA - LU|| (examples/conflux_miniapp.cpp:349-422). Here each
rank runs SUMMA on its own block over the ('x', 'y') plane, one masked
psum over 'y' of the A column panel and one over 'x' of the B row panel
per tile of the contraction (the communication of ScaLAPACK's PB-GEMM),
and the Frobenius norms are psums of per-rank partial sums: only the
final scalars reach the host, and no rank ever holds the whole matrix.
Every product is IEEE fp32 (`precision.ieee_fp32`) on float32 and bf16
blocks (bf16 blocks are upcast first, as the JAX package measures bf16
storage's factors in f32), f64 on float64 blocks and complex on complex
ones; the partial sums accumulate in float64.
"""

from __future__ import annotations

import torch

from conflux_tpu_torch.layout import BlockCyclic, local_row_to_global
from conflux_tpu_torch.ops.collect import panel_rows_for_columns
from conflux_tpu_torch.precision import ieee_fp32
from conflux_tpu_torch.validation import sum_sq


def _gate_dtype(t: torch.Tensor):
    """The dtype a gate computes in: f32 for bf16 blocks, else theirs."""
    return torch.float32 if t.dtype == torch.bfloat16 else t.dtype


def _summa_local(desc: BlockCyclic, A: torch.Tensor,
                 B: torch.Tensor) -> torch.Tensor:
    """This rank's [Ml, Nl] block of C = A @ B on the layer-0
    distribution, one step per tile of the contraction dimension. B may
    be tall (it is read only in its first Nt row tiles)."""
    g = desc.grid
    comm = g.comm
    v, Px, Py = desc.v, g.Px, g.Py
    pi, pj = g.pi, g.pj
    C = torch.zeros_like(A)
    for k in range(desc.Nt):
        # the column panel of A (tiles (:, k)) lives on pj == k % Py
        c = (k // Py) * v
        acol = A[:, c:c + v] if pj == k % Py else A.new_zeros((A.shape[0], v))
        acol = comm.psum(acol, "y")
        # the row panel of B (tiles (k, :)) lives on pi == k % Px
        r = (k // Px) * v
        brow = B[r:r + v] if pi == k % Px else B.new_zeros((v, B.shape[1]))
        brow = comm.psum(brow, "x")
        C += acol @ brow
    return C


@ieee_fp32()
def pgemm(GA: torch.Tensor, GB: torch.Tensor,
          desc: BlockCyclic) -> torch.Tensor:
    """Distributed C = A @ B of square block-cyclic matrices: this rank's
    block of C from its blocks of A and B (layer 0 carries the data, as
    `layout.distribute` gives it; the other layers' blocks of C are
    zeros). None on an idle rank. Every rank of the grid must call it."""
    if desc.grid.idle:
        return None
    return _summa_local(desc, GA, GB)


def _residual_local(desc: BlockCyclic, m_true: int, n_true: int,
                    G: torch.Tensor, F: torch.Tensor, piv: torch.Tensor):
    """(||PA - LU||_F^2, ||A||_F^2) from this rank's blocks: G the input
    (z-partials), F the merged LU of P·A (layer 0; a trapezoid for tall
    M > N), piv the global pivot vector (slot -> original row). Rows and
    columns of the identity padding are masked out of both sums."""
    g = desc.grid
    comm = g.comm
    v, Px, Py = desc.v, g.Px, g.Py
    Ml, Nl = desc.Ml, desc.Nl
    pi, pj, pz = g.pi, g.pj, g.pz
    dev = G.device
    cdt = _gate_dtype(G)
    A = G.to(cdt)
    F = F.to(cdt)
    piv = piv.to(dev)
    slot = local_row_to_global(pi, Px, v, Ml, dev)    # global row slot
    gcol = local_row_to_global(pj, Py, v, Nl, dev)    # global column

    # P·A: slot tile t takes the original rows piv[t v:(t+1) v]; one psum
    # over ('x', 'z') per tile gives the true rows to its owner row
    PA = torch.zeros_like(A)
    for t in range(desc.Mt):
        rows = piv[t * v:(t + 1) * v]
        mine = (rows // v) % Px == pi
        lr = ((rows // v) // Px * v + rows % v).clamp(0, Ml - 1)
        block = comm.psum(torch.where(mine[:, None], A[lr], 0.0),
                          ("x", "z"))
        if pi == t % Px:
            PA[(t // Px) * v:(t // Px + 1) * v] = block

    # L·U by SUMMA on the factors cut out of F by the slot masks
    L = (torch.where(slot[:, None] > gcol[None, :], F, 0.0)
         + (slot[:, None] == gcol[None, :]).to(cdt))
    U = torch.where(slot[:, None] <= gcol[None, :], F, 0.0)
    LU = _summa_local(desc, L, U)

    # P·A's rows are in pivot order, which interleaves the padding rows:
    # the row mask reads each slot's original row
    origrow = piv[slot.clamp(0, desc.M - 1)]
    live = (origrow[:, None] < m_true) & (gcol[None, :] < n_true)
    R = torch.where(live, PA - LU, 0.0)
    Atrue = comm.psum(A, "z")
    livea = (slot[:, None] < m_true) & (gcol[None, :] < n_true)
    Aa = torch.where(livea, Atrue, 0.0)
    # the products are the same on every layer: layer 0's sums count
    sums = torch.stack([sum_sq(R), sum_sq(Aa)])
    return comm.psum(sums if pz == 0 else torch.zeros_like(sums),
                     ("x", "y", "z"))


def _chol_residual_local(desc: BlockCyclic, n_true: int, G: torch.Tensor,
                         Lg: torch.Tensor):
    """(||A - L L^T||_F^2, ||A||_F^2) from this rank's blocks: G the input
    (z-partials), Lg the factor (layer 0). The L^T row panel of each step
    is the step's L column panel, gathered over 'x' and cut to this
    rank's columns as the factorization does it (`panel_rows_for_columns`)."""
    g = desc.grid
    comm = g.comm
    v, Px, Py = desc.v, g.Px, g.Py
    Ml, Nl = desc.Ml, desc.Nl
    pi, pj, pz = g.pi, g.pj, g.pz
    dev = G.device
    cdt = _gate_dtype(G)
    A = comm.psum(G.to(cdt), "z")
    L = Lg.to(cdt)
    LLt = torch.zeros_like(A)
    for k in range(desc.Nt):
        c = (k // Py) * v
        lcol = L[:, c:c + v] if pj == k % Py else L.new_zeros((Ml, v))
        lcol = comm.psum(lcol, "y")
        lrow = panel_rows_for_columns(comm, lcol, v, Px, Py, pj, desc.Ntl)
        LLt += lcol @ lrow.permute(2, 0, 1).reshape(v, Nl)
    # identity padding stays in the trailing rows and columns (no pivots)
    grow = local_row_to_global(pi, Px, v, Ml, dev)
    gcol = local_row_to_global(pj, Py, v, Nl, dev)
    live = (grow[:, None] < n_true) & (gcol[None, :] < n_true)
    R = torch.where(live, A - LLt, 0.0)
    Aa = torch.where(live, A, 0.0)
    # L lives on layer 0 only: layer 0's sums count
    sums = torch.stack([sum_sq(R), sum_sq(Aa)])
    return comm.psum(sums if pz == 0 else torch.zeros_like(sums),
                     ("x", "y", "z"))


@ieee_fp32()
def pchol_residual_25d(G: torch.Tensor, Lg: torch.Tensor, desc: BlockCyclic,
                       n_true: int = 0):
    """Fully distributed ||A - L L^T||_F / (N ||A||_F) of this rank's
    blocks of A and of its factor, the same float on every rank (None on
    an idle rank); n_true masks the identity padding (0 = desc.N). Every
    rank of the grid must call it."""
    if desc.grid.idle:
        return None
    n_true = n_true or desc.N
    r2, a2 = _chol_residual_local(desc, n_true, G, Lg).tolist()
    return r2 ** 0.5 / (n_true * a2 ** 0.5)


@ieee_fp32()
def plu_residual_25d(G: torch.Tensor, F: torch.Tensor, piv: torch.Tensor,
                     desc: BlockCyclic, n_true: int = 0, m_true: int = 0):
    """Fully distributed ||PA - LU||_F / (N ||A||_F) of this rank's blocks
    of A and of its LU factor and the global pivot vector, the same float
    on every rank (None on an idle rank): the in-framework replacement of
    the reference's ScaLAPACK validation plane. n_true / m_true: the
    caller's unpadded dims (0 = the descriptor's); the identity padding is
    masked out of the norms and the normalization uses n_true. Tall
    (M > N) trapezoid factors are handled. Every rank of the grid must
    call it."""
    if desc.grid.idle:
        return None
    n_true = n_true or desc.N
    m_true = m_true or desc.M
    r2, a2 = _residual_local(desc, m_true, n_true, G, F, piv).tolist()
    return r2 ** 0.5 / (n_true * a2 ** 0.5)
