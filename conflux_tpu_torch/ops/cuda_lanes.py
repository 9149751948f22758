"""The panel's pivot-lane gather and scatter on Hopper, by hand in CUDA C++.

`ops/panel._lu_select_loop_t` keeps its panel transposed (matrix rows as
lanes) and, between K1 blocks, reads the factored block's pivot lanes and
writes the finished ones back. The kernels are `csrc/lane_move.cu`, built
by `nvcc` for `sm_90a` at first use (ops/_build.py) and called through
ctypes on PyTorch's current stream; its source note says what bounds them.

They replace no TPU kernel: the JAX package moves these lanes by one-hot
matrix products over all m lanes. The plain versions, which CPU tensors
take, are `ops/panel._gather_lanes` and `_scatter_lanes`.
"""

from __future__ import annotations

import ctypes

import torch

from conflux_tpu_torch.ops import _build

# launches of each kernel in this process; the card tests read them
GATHER_LAUNCHES = 0
SCATTER_LAUNCHES = 0

_lib = None


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load("lane_move")
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.conflux_lane_move.argtypes = [i, p, ll, ll, i, p, p, i, p, i, p]
        lib.conflux_lane_move.restype = i
        lib.conflux_lane_move_error_string.argtypes = [i]
        lib.conflux_lane_move_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _move(scatter: bool, lanes: torch.Tensor, piv: torch.Tensor,
          ok: torch.Tensor, dense: torch.Tensor) -> None:
    dev = lanes.device
    for name, t in (("piv", piv), ("ok", ok), ("dense", dense)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, not on {dev}")
    if not lanes.is_cuda:
        raise ValueError("the lane moves take CUDA tensors")
    if lanes.dtype not in (torch.float32, torch.float64) \
            or dense.dtype != lanes.dtype:
        raise TypeError(f"the lane moves take float32 or float64 tensors of "
                        f"one dtype, not {lanes.dtype} and {dense.dtype}")
    if lanes.dim() != 2:
        raise ValueError(f"lanes must be 2-D, not {tuple(lanes.shape)}")
    rows, m = lanes.shape
    n = piv.shape[0]
    if piv.dtype != torch.int64 or ok.dtype != torch.bool \
            or tuple(ok.shape) != (n,) or piv.dim() != 1:
        raise ValueError("piv must be int64 [n] and ok bool [n]")
    if tuple(dense.shape) != (rows, n):
        raise ValueError(f"dense side {tuple(dense.shape)} is not "
                         f"[{rows}, {n}]")
    if not (piv.is_contiguous() and ok.is_contiguous()
            and dense.is_contiguous()) or (m > 1 and lanes.stride(1) != 1):
        raise ValueError("the lane moves take contiguous piv, ok and dense "
                         "sides and lanes with unit lane stride")
    ld = lanes.stride(0) if rows > 1 else m
    lib = _load()
    # only a tensor off the current device pays for entering its context
    if dev.index != torch.cuda.current_device():
        with torch.cuda.device(dev):
            return _move(scatter, lanes, piv, ok, dense)
    err = lib.conflux_lane_move(
        int(scatter), lanes.data_ptr(), ld, m, rows, piv.data_ptr(),
        ok.data_ptr(), n, dense.data_ptr(), lanes.element_size(),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError("lane move launch failed: "
                           + lib.conflux_lane_move_error_string(err).decode())


def gather_lanes(src: torch.Tensor, piv: torch.Tensor,
                 ok: torch.Tensor) -> torch.Tensor:
    """out[r, j] = src[r, piv[j]] where ok[j], else 0, on the card, into a
    fresh contiguous [rows, n] tensor. src [rows, m] float32 or float64
    with unit lane stride (any row stride); piv int64 [n], ok bool [n]."""
    global GATHER_LAUNCHES
    out = torch.empty((src.shape[0], piv.shape[0]), dtype=src.dtype,
                      device=src.device)
    _move(False, src, piv, ok, out)
    GATHER_LAUNCHES += 1
    return out


def scatter_lanes_(dst: torch.Tensor, piv: torch.Tensor, ok: torch.Tensor,
                   src: torch.Tensor) -> torch.Tensor:
    """dst[r, piv[j]] = src[r, j] for every j with ok[j], on the card, in
    place; returns dst. The lanes of the ok entries must be distinct; an
    entry whose ok is False moves nothing. dst [rows, m] float32 or
    float64 with unit lane stride; src contiguous [rows, n] of its dtype."""
    global SCATTER_LAUNCHES
    _move(True, dst, piv, ok, src)
    SCATTER_LAUNCHES += 1
    return dst
