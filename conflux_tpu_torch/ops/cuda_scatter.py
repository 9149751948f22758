"""K5 and K6 on Hopper: whole-row scatter and gather, by hand in CUDA C++.

Counterpart of `conflux_tpu/ops/pallas_scatter.py` (`scatter_rows`,
kernel `_scatter_kernel`; `gather_rows`, kernel `_gather_kernel`). Both
kernels are in `csrc/row_move.cu`, built by `nvcc` for `sm_90a` at first
use (ops/_build.py) and called through ctypes on PyTorch's current stream.
Its source note says what bounds them on the H100 and what the design
does about that.

Their plain PyTorch versions are `ops/scatter._scatter_rows_t` and
`_gather_rows_t`; `ops/scatter` sends CPU tensors there and CUDA tensors
here.
"""

from __future__ import annotations

import ctypes

import torch

from conflux_tpu_torch.ops import _build
from conflux_tpu_torch.ops.scatter import check_rows

# launches of each kernel in this process, one per wrapper call that
# launches it; chip_smoke.py resets and reads them
SCATTER_ROWS_LAUNCHES = 0       # K5
GATHER_ROWS_LAUNCHES = 0        # K6

_lib = None


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load("row_move")
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.conflux_row_move.argtypes = [i, p, ll, p, ll, p, i, ll, ll, p]
        lib.conflux_row_move.restype = i
        lib.conflux_row_move_error_string.argtypes = [i]
        lib.conflux_row_move_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check_card(name: str, t: torch.Tensor, dev: torch.device):
    if not t.is_cuda or t.device != dev:
        raise ValueError(f"{name} must be a CUDA tensor on {dev}")
    if t.shape[1] > 1 and t.stride(1) != 1:
        raise ValueError(f"{name} needs unit column stride")


def _move(scatter: bool, src: torch.Tensor, dst: torch.Tensor,
          index: torch.Tensor, m: int):
    lib = _load()
    esize = src.element_size()
    with torch.cuda.device(dst.device):
        stream = torch.cuda.current_stream(dst.device).cuda_stream
        err = lib.conflux_row_move(
            int(scatter), src.data_ptr(), src.stride(0) * esize,
            dst.data_ptr(), dst.stride(0) * esize, index.data_ptr(),
            index.shape[0], m, src.shape[1] * esize, stream)
    if err != 0:
        raise RuntimeError(("scatter_rows" if scatter else "gather_rows")
                           + " launch failed: "
                           + lib.conflux_row_move_error_string(err).decode())


def scatter_rows(R: torch.Tensor, src: torch.Tensor,
                 slots: torch.Tensor) -> torch.Tensor:
    """R[slots[i], :] = src[i, :] on the card, in place; returns R. R and
    src float32 or bfloat16 with unit column stride (any row stride);
    slots int64, unique and in [0, m). src must not overlap R."""
    global SCATTER_ROWS_LAUNCHES
    check_rows(R, slots, src)
    _check_card("R", R, R.device)
    _check_card("src", src, R.device)
    if not slots.is_contiguous():
        raise ValueError("slots must be contiguous")
    if slots.shape[0] == 0 or R.shape[1] == 0:
        return R
    _move(True, src, R, slots, R.shape[0])
    SCATTER_ROWS_LAUNCHES += 1
    return R


def gather_rows(R: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[i, :] = R[idx[i], :] on the card, into a fresh contiguous
    tensor. R float32 or bfloat16 with unit column stride (any row
    stride); idx int64 in [0, m)."""
    global GATHER_ROWS_LAUNCHES
    check_rows(R, idx)
    _check_card("R", R, R.device)
    if not idx.is_contiguous():
        raise ValueError("idx must be contiguous")
    out = torch.empty((idx.shape[0], R.shape[1]), dtype=R.dtype,
                      device=R.device)
    if idx.shape[0] == 0 or R.shape[1] == 0:
        return out
    _move(False, R, out, idx, R.shape[0])
    GATHER_ROWS_LAUNCHES += 1
    return out
