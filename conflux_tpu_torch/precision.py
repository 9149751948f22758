"""IEEE fp32 matrix products inside the package's entry points.

The JAX package pins `Precision.HIGHEST` on every fp32 product it forms
(conflux_tpu/ops/tri.py). PyTorch takes the precision of an fp32 product
from process-wide settings instead, and a caller who enables TF32 (or
bf16 on the CPU) would silently change the products that must be IEEE
fp32: the 'highest' products, the panel's updates, the TRSMs and the
residual gates. `ieee_fp32` pins those settings to "ieee" for the length
of one public call and gives the caller's settings back afterwards.

Only the per-backend knobs of PyTorch's newer API are read and written
(`torch.backends.cuda.matmul.fp32_precision` and
`torch.backends.mkldnn.matmul.fp32_precision`): reading the legacy ones
(`allow_tf32`, `get_float32_matmul_precision()`) raises once a caller has
set the newer ones, while these read and restore exactly in every state.
The bf16 products (`torch.mm(..., out_dtype=float32)` on bf16 operands)
do not read them.
"""

from __future__ import annotations

import contextlib

import torch

_KNOBS = (torch.backends.cuda.matmul, torch.backends.mkldnn.matmul)


@contextlib.contextmanager
def ieee_fp32():
    """Run fp32 matrix products as IEEE fp32 inside the block, whatever
    the caller set, and restore the caller's settings on the way out, also
    when the block raises. `@ieee_fp32()` decorates a function the same
    way (a fresh context per call); nested use changes nothing."""
    saved = [knob.fp32_precision for knob in _KNOBS]
    try:
        for knob in _KNOBS:
            knob.fp32_precision = "ieee"
        yield
    finally:
        for knob, value in zip(_KNOBS, saved):
            knob.fp32_precision = value
