"""The panel's pivot-triangle solve on Hopper, by hand in CUDA C++.

X = B L^{-T} for B [r, n] and L the unit lower triangle of the pivot rows'
merged factors lu [n, n]: the U12 of `ops/panel._lu_select_loop_t`'s block
and group updates. The kernel is `csrc/panel_trsm.cu`, built by `nvcc` for
`sm_90a` at first use (ops/_build.py) and called through ctypes on
PyTorch's current stream; its source note says what bounds it on the H100
and how it is laid out.

It replaces no TPU kernel: the JAX package, and the plain version
`ops/panel._pivot_solve_plain` that CPU tensors take, solve these
triangles with 32-wide explicit inverses and matrix products, some eighty
launches a solve on the card. `ops/panel._pivot_solve_t` sends CUDA
tensors here and CPU tensors there.
"""

from __future__ import annotations

import ctypes

import torch

from conflux_tpu_torch.ops import _build

# widest triangle the kernel takes (the panel's groups are 512 wide)
MAX_N = 512

# launches of the kernel in this process; the card tests read it
LAUNCHES = 0

_lib = None


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load("panel_trsm")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.conflux_panel_trsm.argtypes = [p, p, p, i, i, i, p]
        lib.conflux_panel_trsm.restype = i
        lib.conflux_panel_trsm_error_string.argtypes = [i]
        lib.conflux_panel_trsm_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def solve_unit_lower_t(B: torch.Tensor, lu: torch.Tensor) -> torch.Tensor:
    """X = B L^{-T} on the card, L = tril(lu, -1) + I: B [r, n] row-major,
    lu [n, n] column-major (lu.T contiguous, as the panel's pivot-lane
    gather leaves it), read in place; lu's diagonal and upper part are never read.
    float32 (IEEE fused multiply-adds, no TF32) or float64, 1 <= n <=
    MAX_N, r >= 1; raises on anything else or on a failed launch."""
    global LAUNCHES
    if not B.is_cuda or lu.device != B.device:
        raise ValueError("solve_unit_lower_t takes CUDA tensors on one "
                         "device")
    if B.dtype not in (torch.float32, torch.float64) or lu.dtype != B.dtype:
        raise TypeError(f"solve_unit_lower_t takes float32 or float64 "
                        f"tensors of one dtype, not {B.dtype} and "
                        f"{lu.dtype}")
    if B.dim() != 2 or tuple(lu.shape) != (B.shape[1], B.shape[1]):
        raise ValueError(f"shapes B {tuple(B.shape)} and lu "
                         f"{tuple(lu.shape)} are not [r, n] and [n, n]")
    r, n = B.shape
    if not (r >= 1 and 1 <= n <= MAX_N):
        raise ValueError(f"B [{r}, {n}] outside r >= 1, 1 <= n <= {MAX_N}")
    if not (B.is_contiguous() and lu.T.is_contiguous()):
        raise ValueError("solve_unit_lower_t takes a contiguous B and a "
                         "column-major lu (lu.T contiguous)")
    lib = _load()
    X = torch.empty_like(B)
    with torch.cuda.device(B.device):
        stream = torch.cuda.current_stream(B.device).cuda_stream
        err = lib.conflux_panel_trsm(B.data_ptr(), lu.data_ptr(),
                                     X.data_ptr(), r, n,
                                     int(B.dtype == torch.float64), stream)
    if err != 0:
        raise RuntimeError("panel_trsm launch failed: "
                           + lib.conflux_panel_trsm_error_string(err)
                           .decode())
    LAUNCHES += 1
    return X
