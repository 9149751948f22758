"""Stepped LU: the factorization in one copy of A on the card.

PyTorch counterpart of `conflux_tpu/lu/stepped.py`. The in-memory paths
of `lu/single.py` hold A, the working region and F together (crout peaks
at about four copies of A), so the largest matrix one card factors with
them is about half of what it could hold. `lu_factor_stepped` factors in
one working buffer instead: the caller's own tensor when it is already
on the card (it is consumed, as LAPACK's overwrite_a), or one buffer the
host array is uploaded into, row block by row block. The factor then
either stays on the card or streams to the host in factor-order row
blocks, so the card never holds a second copy.

'flat' (the default) runs the JAX package's masked, non-splice panel
step in place on the full-size buffer, in original row order: the panel
factorization over the live rows (K1 on the card), the panel-column
write, U12 from the pivot rows' raw trailing content, and ONE trailing
update R[:, k+w:] -= Mgemm @ U12 (`lu.single.trailing_update`, K3 on the
card), where Mgemm holds the live rows' multipliers and zeros on every
finished row. The JAX step also puts strict(L11) on this step's pivot
rows, so that the update turns their raw trailing content into
raw - strict(L11) @ U12 = U12; that difference cancels a w-term product
down to U12 and keeps the product's rounding, which bf16 storage's
one-pass product makes as large as U12 itself (||PA - LU||_F / ||A||_F
1.14 at N = 65536 in bf16 on an H100; the JAX package's own record,
results/benchmarks.csv:100, is 1.57). The port writes the exact U12 into
the pivot rows instead, as the flat scheme splices it into its bands.
Its pivots are those of the JAX stepped driver and of
`lu_factor(scheme='flat')`. 'crout' runs `lu.single._getrf_crout`
itself on the consumed buffer, its live rows compacted into the
buffer's prefix in place, beside the growing factor F: two copies, with
crout's one rounding per stored entry.

The JAX driver exists because of a TPU's compile helper and 16 GB of
memory: one jit per step with a dynamic step index, the trailing update
cut into `lax.cond`-guarded column chunks. Eager PyTorch needs neither;
`chunk` is kept and sizes the row blocks that move between host and
card (and crout's in-place compaction).
"""

from __future__ import annotations

import numpy as np
import torch

from conflux_tpu_torch.errors import ConfluxError, ErrorCode
from conflux_tpu_torch.interop import host_tensor, resolve_device
from conflux_tpu_torch.lu.single import (
    _getrf_crout,
    compute_dtype,
    trailing_update,
)
from conflux_tpu_torch.ops.panel import factor_panel
from conflux_tpu_torch.ops.tri import trsm_left_lower_unit, unit_lower
from conflux_tpu_torch.precision import ieee_fp32

_DTYPES = (torch.float32, torch.bfloat16)


def working_buffer(A, device, entry: str, square: bool = False,
                   rows: int = 8192) -> torch.Tensor:
    """The one buffer a stepped driver factors in: A itself when it is a
    contiguous float32 or bfloat16 tensor on `device` (consumed), else one
    `torch.empty` on `device` that A (a float32 or `ml_dtypes.bfloat16`
    numpy array, or another tensor) is copied into `rows` rows at a time,
    A left as it was. Raises
    the JAX drivers' errors: INVALID_SHAPE for a wide (or, `square`, a
    non-square) A, INVALID_TYPE for another dtype."""
    m, n = A.shape
    if (m != n) if square else (m < n):
        want = "a square" if square else "an m >= n"
        raise ConfluxError(ErrorCode.INVALID_SHAPE,
                           f"{entry} expects {want} matrix, got "
                           f"{tuple(A.shape)}")
    given = isinstance(A, torch.Tensor)
    if not given:
        A = host_tensor(A)      # a view: the copy below is by row blocks
    if A.dtype not in _DTYPES:
        raise ConfluxError(ErrorCode.INVALID_TYPE,
                           f"{entry} takes float32 or bfloat16, not "
                           f"{A.dtype}")
    device = resolve_device(device)
    if given and A.device == device and A.is_contiguous():
        return A
    R = torch.empty((m, n), dtype=A.dtype, device=device)
    for r0 in range(0, m, rows):
        R[r0:r0 + rows].copy_(A[r0:r0 + rows])
    return R


def device_room(dev: torch.device) -> int:
    """Bytes a new tensor can still take on `dev`: the card's free memory
    plus what PyTorch's allocator holds unused; unbounded on the CPU."""
    if dev.type != "cuda":
        return 1 << 62
    free, _ = torch.cuda.mem_get_info(dev)
    return free + torch.cuda.memory_reserved(dev) - \
        torch.cuda.memory_allocated(dev)


def rows_to_host(X: torch.Tensor, idx, rows: int) -> np.ndarray:
    """X[idx] (all of X's rows in order when idx is None) as a host numpy
    array, gathered and copied `rows` rows at a time, so the card holds
    one block beside X. A bfloat16 X lands as float32, which holds its
    values exactly."""
    m = X.shape[0] if idx is None else idx.shape[0]
    dt = torch.float32 if X.dtype == torch.bfloat16 else X.dtype
    out = torch.empty((m, X.shape[1]), dtype=dt)
    for r0 in range(0, m, rows):
        r1 = min(r0 + rows, m)
        blk = X[r0:r1] if idx is None else X.index_select(0, idx[r0:r1])
        out[r0:r1].copy_(blk)
    return out.numpy()


def _flat_steps(R: torch.Tensor, v: int, precision: str) -> torch.Tensor:
    """Factor R [m, n] in place, in original row order; returns perm."""
    m, n = R.shape
    dev = R.device
    cdt = compute_dtype(R.dtype)
    avail = torch.ones(m, dtype=torch.bool, device=dev)
    porder = torch.empty(n, dtype=torch.int64, device=dev)
    for k in range(0, n, v):
        w = min(v, n - k)
        panel = R[:, k:k + w].to(cdt)
        # the same masked panel factorization as the flat scheme's
        piv, _, M = factor_panel(panel, avail, w, block=128)
        lu_top = M[piv]
        R[:, k:k + w] = torch.where(avail[:, None], M, panel)
        avail[piv] = False
        porder[k:k + w] = piv
        if k + w < n:
            U12 = trsm_left_lower_unit(unit_lower(lu_top),
                                       R[piv, k + w:].to(cdt),
                                       method="invert")
            # live rows: multipliers; finished rows, this step's pivots
            # among them, zeros: the update leaves them as they are
            trailing_update(R, torch.where(avail[:, None], M, 0.0), U12,
                            k + w, precision)
            # the pivot rows' U12 spliced in exactly (module docstring)
            R[piv, k + w:] = U12.to(R.dtype)
    if m > n:
        # never-pivoted rows follow in their original order
        porder = torch.cat([porder, torch.nonzero(avail).flatten()])
    return porder


@ieee_fp32()
def lu_factor_stepped(A, v: int = 1024, precision: str = "highest",
                      chunk: int = 8192, out: str = "auto",
                      scheme: str = "flat", device="cuda"):
    """LU with partial pivoting in one copy of A: (F, perm) with
    A[perm] = unit_lower(F) @ upper(F), the contract of `lu_factor`.

    A: [m, n] (m >= n), float32 or bfloat16 (storage: a bf16 buffer and
    factor, f32 panels, pivoting and TRSMs), a tensor or a float32 numpy
    array. A contiguous tensor on `device` (the card unless the caller
    asks for the CPU) is CONSUMED: factored in place (flat: on return it
    holds the factor in original row order, F = A[perm]; crout: working
    values). Anything else is uploaded into one buffer on `device` and
    left untouched.
    precision: 'highest' (IEEE fp32), 'high' or 'bf16' for the trailing
    update (flat) or the big-K products (crout); bf16 storage runs its
    products in bf16 whatever it says. out: 'device' (F a tensor on
    `device`; flat gathers F = R[perm] there, a second copy), 'host'
    (F a numpy array, streamed in factor-order row blocks; a bf16 F lands
    as float32) or 'auto' ('device' when the card's free memory takes
    that second copy, else 'host'; crout and a CPU `device` always
    'device'). perm is int64, on F's side. scheme:
    'flat' or 'crout' (module docstring). chunk: rows per block moved
    between host and card and per block of crout's in-place compaction."""
    if scheme not in ("flat", "crout"):
        raise ConfluxError(ErrorCode.INVALID_SHAPE,
                           f"unknown scheme {scheme!r}")
    if out not in ("auto", "device", "host"):
        raise ConfluxError(ErrorCode.INVALID_SHAPE, f"unknown out {out!r}")
    dev = resolve_device(device)
    R = working_buffer(A, dev, "lu_factor_stepped", rows=chunk)
    if scheme == "crout":
        if R.nbytes > device_room(dev):
            raise ConfluxError(
                ErrorCode.INVALID_SHAPE,
                f"crout-stepped needs its factor beside the working buffer "
                f"({R.nbytes / 1e9:.1f} GB, more than {dev} has free); use "
                f"scheme='flat' (in place, one copy) at this size")
        F, perm = _getrf_crout(R, v, precision, consume=True,
                                chunk=chunk)
        del R
        if out == "host":
            return rows_to_host(F, None, chunk), perm.cpu().numpy()
        return F, perm
    perm = _flat_steps(R, v, precision)
    if out == "auto":
        out = "device" if R.nbytes <= device_room(dev) else "host"
    if out == "device":
        return R.index_select(0, perm), perm
    return rows_to_host(R, perm, chunk), perm.cpu().numpy()

