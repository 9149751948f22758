"""The diagonal blocks of crout's winners' solve on Hopper, by hand in CUDA C++.

X = L^{-1} B for one diagonal block of `ops/tri.solve_lower_rows`: L the
unit lower triangle of a [b, b] block of the pivot rows' merged factors,
read in place through its strides, B and X [b, c] row-major. The kernel
is `csrc/lower_solve.cu`, built by `nvcc` for `sm_90a` at first use
(ops/_build.py) and called through ctypes on PyTorch's current stream;
its source note says what bounds it on the H100 and how it is laid out.

It replaces no TPU kernel: the JAX package, and the CPU tensors here
(`ops/tri._solve_unit_lower_blocked`), solve these rows with 32-wide
explicit inverses and matrix products, ~208 launches a 1536-row solve on
the card. The plain version of this kernel is `ops/tri._diag_solve_plain`.
"""

from __future__ import annotations

import ctypes

import torch

from conflux_tpu_torch.ops import _build

# widest diagonal block the kernel takes
MAX_ROWS = 512

# launches of the kernel in this process; the card tests read it
LAUNCHES = 0

_lib = None


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load("lower_solve")
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.conflux_lower_solve.argtypes = [p, ll, ll, p, ll, p, ll, i, i, i,
                                            p]
        lib.conflux_lower_solve.restype = i
        lib.conflux_lower_solve_error_string.argtypes = [i]
        lib.conflux_lower_solve_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def solve_diag(lu: torch.Tensor, B: torch.Tensor, X: torch.Tensor) -> None:
    """X = L^{-1} B on the card, written into X, L = tril(lu, -1) + I:
    lu [b, b] with a unit stride, row- or column-major (only its strict
    lower part is read), B and X [b, c] with unit column stride (X may be
    a slice of a larger matrix) in memory spans that do not overlap.
    float32 (IEEE fused multiply-adds, no TF32) or float64,
    1 <= b <= MAX_ROWS, c >= 1; raises before any launch on anything
    else, and on a failed launch."""
    global LAUNCHES
    if not (lu.is_cuda and B.device == lu.device and X.device == lu.device):
        raise ValueError("solve_diag takes CUDA tensors on one device")
    if lu.dtype not in (torch.float32, torch.float64) \
            or B.dtype != lu.dtype or X.dtype != lu.dtype:
        raise TypeError(f"solve_diag takes float32 or float64 tensors of one "
                        f"dtype, not {lu.dtype}, {B.dtype} and {X.dtype}")
    if lu.dim() != 2 or B.dim() != 2 or X.dim() != 2 \
            or lu.shape[0] != lu.shape[1] or B.shape[0] != lu.shape[0] \
            or X.shape != B.shape:
        raise ValueError(f"shapes lu {tuple(lu.shape)}, B {tuple(B.shape)} "
                         f"and X {tuple(X.shape)} are not [b, b], [b, c] "
                         f"and [b, c]")
    b, c = B.shape
    if not (1 <= b <= MAX_ROWS and c >= 1):
        raise ValueError(f"B [{b}, {c}] outside 1 <= b <= {MAX_ROWS}, c >= 1")
    for name, t in (("B", B), ("X", X)):
        if t.stride(1) != 1 or (b > 1 and t.stride(0) < c):
            raise ValueError(f"{name} must be row-major with unit column "
                             f"stride, not strides {t.stride()}")
    if min(lu.stride()) < 0 or 1 not in lu.stride():
        raise ValueError(f"lu must have a unit stride, not {lu.stride()}")
    lo = min(B.data_ptr(), X.data_ptr())
    hi = max(B.data_ptr(), X.data_ptr())
    first = B if B.data_ptr() == lo else X
    if hi < lo + ((b - 1) * first.stride(0) + c) * B.element_size():
        raise ValueError("B and X overlap")
    lib = _load()
    lsr, lsc = lu.stride()
    with torch.cuda.device(B.device):
        stream = torch.cuda.current_stream(B.device).cuda_stream
        err = lib.conflux_lower_solve(
            lu.data_ptr(), lsr, lsc, B.data_ptr(),
            B.stride(0) if b > 1 else c, X.data_ptr(),
            X.stride(0) if b > 1 else c, b, c,
            int(B.dtype == torch.float64), stream)
    if err != 0:
        raise RuntimeError("lower_solve launch failed: "
                           + lib.conflux_lower_solve_error_string(err)
                           .decode())
    LAUNCHES += 1
