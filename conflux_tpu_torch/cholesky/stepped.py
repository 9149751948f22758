"""Stepped Cholesky: the factorization in one copy of A on the card.

PyTorch counterpart of `conflux_tpu/cholesky/stepped.py`, the Cholesky
analog of `lu/stepped.py`: the left-looking flat steps of
`cholesky/single.py` (`potrf_inplace`) run on one buffer, the caller's
tensor when it is already on the card (consumed) or one buffer the host
array is uploaded into. Each step updates the live strip of its panel
columns, strip[k:] -= F[k:, :k] @ F[k:k+w, :k]^T, by one product (K2 in
'high' on the card), factors its w x w tile (`potrf_tile`: K1 forced)
and solves the rows below it. The factor is then made lower triangular
in place in row blocks, and stays there or streams to the host. The JAX
driver's `lax.cond` block grid is a static-shape workaround that eager
PyTorch does not need.
"""

from __future__ import annotations

from conflux_tpu_torch.cholesky.single import potrf_inplace
from conflux_tpu_torch.errors import ConfluxError, ErrorCode
from conflux_tpu_torch.lu.stepped import rows_to_host, working_buffer
from conflux_tpu_torch.precision import ieee_fp32


@ieee_fp32()
def cholesky_stepped(A, v: int = 1024, precision: str = "highest",
                     out: str = "auto", chunk: int = 8192, device="cuda"):
    """Lower Cholesky factor in one copy of A, the contract of `cholesky`.
    A: [n, n] SPD, float32 or bfloat16 (storage), a tensor or a float32
    numpy array. A contiguous tensor on `device` (the card unless the
    caller asks for the CPU) is CONSUMED: with out='device' the factor is
    A itself. Anything else is uploaded into one buffer on `device` and
    left untouched. precision: the panel updates' product ('highest',
    'high', 'bf16'; bf16 storage runs 'bf16'). out: 'device' (the
    factor, made lower triangular in place), 'host' (a numpy array of its
    lower-triangular row blocks; a bf16 factor lands as float32) or
    'auto' (= 'device': neither needs a second copy on the card; the
    host stream too clears the upper triangle of the card's buffer
    first). chunk: rows per block moved between host and card and per
    block of the in-place tril."""
    if out not in ("auto", "device", "host"):
        raise ConfluxError(ErrorCode.INVALID_SHAPE, f"unknown out {out!r}")
    F = working_buffer(A, device, "cholesky_stepped", square=True,
                       rows=chunk)
    potrf_inplace(F, v, precision)
    for r0 in range(0, F.shape[0], chunk):
        F[r0:r0 + chunk].tril_(r0)
    if out == "host":
        return rows_to_host(F, None, chunk)
    return F
