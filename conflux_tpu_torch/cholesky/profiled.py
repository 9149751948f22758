"""The distributed Cholesky run substep by substep, each substep fenced
and timed: the reference's PP() attribution table.

PyTorch counterpart of `conflux_tpu/cholesky/profiled.py`. The reference
times each Cholesky substep (PE(choleskyA00_compute),
PE(updateA10_*), PE(computeA11_dgemm), PE(reduceA11_reduction),
PE(scatterA11_*) throughout src/conflux/cholesky/Cholesky.cpp:188-715;
CholeskyProfiler.h:17-32). `cholesky_25d_profiled` runs the
right-looking rank program itself (`cholesky.p25d.
_local_cholesky_25d_unrolled`, as `cholesky_25d(..., unroll=False)` runs
it) with each substep inside a profiler region that closes on a fence of
the rank's device:

  step0_reduce      the lazy z-psum of the step's tile column (reduceA11)
  step1_potrf       the a00 psum over ('x', 'y') and the redundant tile
                    potrf (choleskyA00; K1 forced on the card)
  step2_trsm_write  the panel TRSM and the factor-column write (updateA10)
  step3_bcast       the per-layer slice psum and the row broadcast
                    (scatterA11)
  step4_update      the split-K trailing product (computeA11)

The factor is that of `cholesky_25d(..., unroll=False)` bit for bit.
"""

from __future__ import annotations

import torch

from conflux_tpu_torch import profiler
from conflux_tpu_torch.cholesky.p25d import (
    _check,
    _local_cholesky_25d_unrolled,
)
from conflux_tpu_torch.layout import BlockCyclic
from conflux_tpu_torch.precision import ieee_fp32


@ieee_fp32()
def cholesky_25d_profiled(G: torch.Tensor, desc: BlockCyclic,
                          precision: str = "highest"):
    """`cholesky_25d(G, desc, precision, unroll=False)` substep by
    substep, each substep a fenced region of the profiler (module
    docstring); the same factor block, None on an idle rank (on a
    (1, 1, 1) grid `cholesky_25d` runs the single-device `_potrf_flat` instead;
    this runs the rank program there too). Call under
    profiler.enable(True) and print the table with profiler.PP(). Every
    rank of the grid must call it."""
    if desc.grid.idle:
        return None
    _check(G, desc)

    def region(name):
        return profiler.region(name, sync=G)

    return _local_cholesky_25d_unrolled(desc, precision, G, region=region)
