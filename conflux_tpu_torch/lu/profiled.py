"""The distributed LU run substep by substep, each substep fenced and
timed: the reference's PP() attribution table.

PyTorch counterpart of `conflux_tpu/lu/profiled.py`. The reference times
each substep region (PE(step0_reduce) ... throughout
src/conflux/lu/conflux_opt.hpp; profiler.hpp:5-19) and prints a sorted
table with PP(). The JAX package splits its rank program into five
separately compiled programs to time them; eager PyTorch needs no split:
`lu_25d_profiled` runs the right-looking rank program itself
(`lu.p25d._local_lu_25d`, as `lu_25d(..., unroll=False)` runs it, no row
rebalance) with each substep inside a profiler region that closes on a
fence of the rank's device:

  step0_reduce   the lazy z-psum of the panel column
  step1_pivot    the tournament / gather / full / none selection and the
                 y-broadcast of the winners
  step23_rows    the pivot-row psum over ('x', 'z')
  step45_trsm    both TRSMs and the factor and panel writes
  step6_update   the per-layer L10 broadcast and the split-K trailing
                 update (`_trailing_sub`: K3 on the card in 'high'/'bf16')

The fences are the only difference: the factor and the pivots are those
of `lu_25d(..., unroll=False)` bit for bit, and every kernel launches as
often. Each fence waits for the card, so the table's value is each
substep's share, not the sum (compare the sum with the unprofiled wall).
"""

from __future__ import annotations

import torch

from conflux_tpu_torch import profiler
from conflux_tpu_torch.layout import BlockCyclic
from conflux_tpu_torch.lu.p25d import _check, _local_lu_25d
from conflux_tpu_torch.precision import ieee_fp32


@ieee_fp32()
def lu_25d_profiled(G: torch.Tensor, desc: BlockCyclic,
                    pivoting: str = "tournament",
                    precision: str = "highest"):
    """`lu_25d(G, desc, pivoting, precision, unroll=False)` substep by
    substep, each substep a fenced region of the profiler (module
    docstring); the same (F, pivots), (None, None) on an idle rank. (On
    a (1, 1, 1) grid `lu_25d` runs a single-device scheme instead; this
    runs the rank program there too.) Call
    under profiler.enable(True) and print the table with profiler.PP().
    Every rank of the grid must call it."""
    if desc.grid.idle:
        return None, None
    _check(G, desc, pivoting)

    def region(name):
        # the table keeps the substeps' own names, without the rank
        # program's span prefix
        return profiler.region(name.removeprefix("lu25d."), sync=G)

    return _local_lu_25d(desc, pivoting, precision, G, region=region)
