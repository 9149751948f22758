"""2.5D distributed Cholesky (CONFCHOX), one process per rank.

PyTorch counterpart of `conflux_tpu/cholesky/p25d.py`. Each rank holds its
[Ml, Nl] block of the z-partial layout (layout.py) and runs the rank
program below on it, moving data only through the named-axis collectives
of `comm.Comm`:

  * the step-k tile column is reduced over 'z' only when it is needed
    (reduceA11, Cholesky.cpp:581-620): the trailing matrix stays as
    per-layer partial sums;
  * the diagonal tile is psum-broadcast over ('x', 'y') and factored
    redundantly on every rank (choleskyA00, Cholesky.cpp:188-194) by
    `potrf_tile`, whose unpivoted elimination is K1 in forced mode on the
    card (its tile route);
  * the column is TRSM'd, only layer pz's l = ceil(v/Pz) slice of it
    moves over 'y' and 'x' (`panel_rows_for_columns`), and each layer
    subtracts its rank-l slice of the trailing update (updateA10 and
    computeA11, Cholesky.cpp:218-378).

The JAX package has 'fori', 'unrolled' and 'windowed' versions of that
program to bound XLA's trace; in eager PyTorch all three are the one
right-looking program whose step k slices its exact live window
[r0:, c0:]. 'lookahead' splits each trailing update so the next step's
column is updated and reduced first. 'crout' is the left-looking program:
no trailing update, each column assembled by one big-K product against
the frozen columns (the distributed `_potrf_flat`). Factor values live on
layer 0, zeros on the others, so the z-partial invariant holds throughout.

Dtypes, as in the JAX package: float32, float64 (f64 throughout) and
bfloat16 STORAGE in every variant: blocks, z-partials and the factor stay
bf16 while every reduction, the tile potrf and the TRSMs run in f32
(slices upcast before each psum); the right-looking trailing update is
one 'bf16out' product rounded into the bf16 block, and the crout
program's big-K correction is 'bf16' on the bf16 factor columns.
"""

from __future__ import annotations


import torch

from conflux_tpu_torch.dispatch import choose_variant, normalize_variant
from conflux_tpu_torch.errors import ConfluxError, ErrorCode
from conflux_tpu_torch.layout import (
    BlockCyclic,
    distribute,
    local_tile_to_global,
    undistribute,
)
from conflux_tpu_torch.lu.single import check_dtype, compute_dtype
from conflux_tpu_torch.ops.collect import panel_rows_for_columns
from conflux_tpu_torch.ops.tri import potrf_tile, schur_dot, trsm_right_lower_t
from conflux_tpu_torch.precision import ieee_fp32
from conflux_tpu_torch.profiler import span


def _local_cholesky_25d_unrolled(desc: BlockCyclic, precision: str,
                                 G: torch.Tensor,
                                 lookahead: bool = False,
                                 region=span) -> torch.Tensor:
    """The right-looking rank program on this rank's block G (not
    modified); returns its block of the factor. Step k works on the live
    window [r0:, c0:] with r0 = (k // Px) v and c0 = (k // Py) v, the
    local rows and columns whose global tiles may still be >= k.

    lookahead=True splits every trailing update: step k+1's tile column is
    updated and z-reduced by a small product before the bulk of the
    window (the dependence structure of the reference's `updateComputeA10`
    overlap, Cholesky.cpp:380-564). region(name) is entered around each
    substep (step0_reduce, step1_potrf, step2_trsm_write, step3_bcast,
    step4_update): the profiled program's fenced timers
    (cholesky/profiled.py); `profiler.span` otherwise
    (a null context unless profiled)."""
    g = desc.grid
    comm = g.comm
    v, Px, Py, Pz = desc.v, g.Px, g.Py, g.Pz
    Ml = desc.Ml
    l = desc.nlayr
    kpad = Pz * l - v
    pi, pj, pz = g.pi, g.pj, g.pz
    dev = G.device
    gt_row = local_tile_to_global(pi, Px, v, Ml, dev)
    gt_col = local_tile_to_global(pj, Py, v, desc.Nl, dev)

    cdt = compute_dtype(G.dtype)   # A keeps G's (storage) dtype
    mode = "bf16out" if G.dtype == torch.bfloat16 else precision
    A = G.clone()
    colnext = comm.psum(A[:, :v].to(cdt), "z") if lookahead else None
    for k in range(desc.Nt):
        r0 = (k // Px) * v   # conservative live-row frontier (rank-invariant)
        c0 = (k // Py) * v
        ntl_live = desc.Ntl - k // Py
        own_y = pj == k % Py
        own_x = pi == k % Px

        with region("step0_reduce"):
            colk = (colnext if lookahead
                    else comm.psum(A[r0:, c0:c0 + v].to(cdt), "z"))
        with region("step1_potrf"):
            diag = colk[:v]
            a00 = comm.psum(diag if own_x and own_y
                            else torch.zeros_like(diag), ("x", "y"))
            L00 = potrf_tile(a00)

        with region("step2_trsm_write"):
            Lcol = trsm_right_lower_t(colk, L00, method="invert")
            Lcol = torch.where(gt_row[r0:, None] > k, Lcol, 0.0)
            if own_y:
                # the factor column: zeros above the live window, L00 on
                # the diagonal tile, the TRSM result below; layer 0 only
                A[:, c0:c0 + v] = 0.0
                if pz == 0:
                    A[r0:, c0:c0 + v] = Lcol
                    if own_x:
                        A[r0:r0 + v, c0:c0 + v] = L00

        # only this layer's l-wide slice of the panel moves over 'y' and 'x'
        with region("step3_bcast"):
            Lcolp = torch.nn.functional.pad(Lcol, (0, kpad)) if kpad else Lcol
            Lk = comm.psum(Lcolp[:, pz * l:(pz + 1) * l] if own_y
                           else Lcol.new_zeros((Ml - r0, l)), "y")
            Lrow = panel_rows_for_columns(comm, Lk, v, Px, Py, pj, ntl_live,
                                          base_row_tile=k // Px,
                                          base_col_tile=k // Py)
            W = Lrow.permute(2, 0, 1).reshape(l, ntl_live * v)
        with region("step4_update"):
            if lookahead and k + 1 < desc.Nt:
                # the next step's column first, then the rest of the window
                # (rows leaving the window at k+1 still take this update)
                c1 = ((k + 1) // Py) * v
                r0n = ((k + 1) // Px) * v
                updn = schur_dot(Lk, W[:, c1 - c0:c1 - c0 + v], mode)
                liven = ((gt_row[r0:, None] > k)
                         & (gt_col[None, c1:c1 + v] > k))
                A[r0:, c1:c1 + v] -= torch.where(liven, updn, 0.0)
                colnext = comm.psum(A[r0n:, c1:c1 + v].to(cdt), "z")
                W = W.clone()
                W[:, c1 - c0:c1 - c0 + v] = 0.0
            upd = schur_dot(Lk, W, mode)
            live = (gt_row[r0:, None] > k) & (gt_col[None, c0:] > k)
            A[r0:, c0:] -= torch.where(live, upd, 0.0)
    return A


def _local_cholesky_25d_crout(desc: BlockCyclic, precision: str,
                              G: torch.Tensor) -> torch.Tensor:
    """The left-looking (crout) rank program: no trailing update. Per step
    k, the factor's tile row k restricted to the frozen columns
    ([v, ~k v / Py], on pi == k % Px, layer 0) is psum'd over ('x', 'z')
    to every rank of its 'y' column; each rank forms the correction
    Lfrozen_local @ slab^T by one big-K product, and one psum over
    ('y', 'z') of (raw partials on the owner column minus the layer-0
    correction) gives the updated column on every rank. The diagonal tile
    then needs only a psum over 'x'."""
    g = desc.grid
    comm = g.comm
    v, Px, Py = desc.v, g.Px, g.Py
    Ml = desc.Ml
    pi, pj, pz = g.pi, g.pj, g.pz
    dev = G.device
    gt_row = local_tile_to_global(pi, Px, v, Ml, dev)
    gt_col = local_tile_to_global(pj, Py, v, desc.Nl, dev)

    cdt = compute_dtype(G.dtype)   # A keeps G's (storage) dtype
    gmode = "bf16" if G.dtype == torch.bfloat16 else precision
    A = G.clone()
    for k in range(desc.Nt):
        r0 = (k // Px) * v      # live-row frontier; tile k sits at r0 on
        #                         its owner row
        c = (k // Py) * v       # the step column on its owner column
        c0f = -(-k // Py) * v   # frozen local column bound (boundary tiles
        #                         >= k are masked in the slab)
        own_y = pj == k % Py
        own_x = pi == k % Px

        if k > 0:
            rowk = A[r0:r0 + v, :c0f]
            rowk = torch.where((gt_col[None, :c0f] < k) & own_x, rowk, 0.0)
            slab = comm.psum(rowk.to(cdt), ("x", "z"))         # [v, c0f]
            # frozen columns are exact zeros on layers pz > 0
            partial = (schur_dot(A[r0:, :c0f], slab, gmode, bt=True)
                       if pz == 0 else A.new_zeros((Ml - r0, v), dtype=cdt))
        else:
            partial = A.new_zeros((Ml - r0, v), dtype=cdt)
        rawc = A[r0:, c:c + v].to(cdt)
        colk = comm.psum((rawc if own_y else torch.zeros_like(rawc))
                         - partial, ("y", "z"))
        diag = colk[:v]
        a00 = comm.psum(diag if own_x else torch.zeros_like(diag), "x")
        L00 = potrf_tile(a00)

        Lcol = trsm_right_lower_t(colk, L00, method="invert")
        Lcol = torch.where(gt_row[r0:, None] > k, Lcol, 0.0)
        if own_y:
            A[:, c:c + v] = 0.0
            if pz == 0:
                A[r0:, c:c + v] = Lcol
                if own_x:
                    A[r0:r0 + v, c:c + v] = L00
    return A


def _check(G: torch.Tensor, desc: BlockCyclic):
    if desc.M != desc.N:
        raise ConfluxError(ErrorCode.INVALID_SHAPE,
                           "cholesky requires a square matrix")
    check_dtype(G, "cholesky_25d")
    if tuple(G.shape) != (desc.Ml, desc.Nl):
        raise ConfluxError(ErrorCode.LAYOUT_MISMATCH,
                           f"block {tuple(G.shape)} is not the descriptor's "
                           f"{(desc.Ml, desc.Nl)}")


def choose_unroll(desc: BlockCyclic, algorithm: str = "cholesky") -> bool:
    """Round-1 compatibility shim over `dispatch.choose_variant`: True iff
    the unrolled variant is selected."""
    return choose_variant(desc, algorithm) == "unrolled"


@ieee_fp32()
def cholesky_25d(G: torch.Tensor, desc: BlockCyclic,
                 precision: str = "highest", unroll=None) -> torch.Tensor:
    """Distributed lower Cholesky of this rank's [Ml, Nl] block G of the
    z-partial layout (`layout.distribute` makes one); returns this rank's
    block of the factor L (layer 0 carries L, the other layers zeros),
    None on an idle rank. Every rank of the grid must call it.

    unroll: None auto-selects (dispatch.choose_variant), True/False force
    'unrolled'/'fori', or a variant name. 'fori', 'unrolled' and
    'windowed' run the same right-looking program (module docstring), so
    the JAX package's `windows` has no counterpart. precision: the
    trailing and big-K products
    ('highest', 'high', 'bf16'); tiles and TRSMs stay IEEE fp32. G
    float32, float64 or bfloat16 (storage: the module docstring). A
    (1, 1, 1) grid runs the single-device `_potrf_flat`."""
    if desc.grid.idle:
        return None
    _check(G, desc)
    variant = normalize_variant(unroll, desc, "cholesky")
    if desc.grid.P == 1:
        from conflux_tpu_torch.cholesky.single import _potrf_flat

        return _potrf_flat(G, desc.v, precision)
    if variant == "crout":
        return _local_cholesky_25d_crout(desc, precision, G)
    return _local_cholesky_25d_unrolled(desc, precision, G,
                                        lookahead=variant == "lookahead")


@ieee_fp32()
def pcholesky(A, grid, v: int = 128, precision: str = "highest",
              unroll=None, root: int = 0):
    """Dense [N, N] SPD matrix (numpy or a tensor, on every rank) -> the
    dense lower factor, [N, N], on grid rank `root` (None elsewhere). The
    distributed analog of `conflux::parallelCholesky`
    (Cholesky.cpp:857-921)."""
    desc = BlockCyclic.create(A.shape[0], A.shape[1], v, grid)
    L = cholesky_25d(distribute(A, desc), desc, precision, unroll)
    L = undistribute(L, desc, root)
    return None if L is None else L[:A.shape[0], :A.shape[1]]
