"""K1 on Hopper: the rank-1 pivot-selection block, by hand in CUDA C++.

Counterpart of `conflux_tpu/ops/pallas_panel.py` (`rank1_block_pallas_t`,
kernel `_rank1_kernel`). The kernel is `csrc/rank1_panel.cu`, built by
`nvcc` for `sm_90a` at first use (ops/_build.py) and called through
ctypes on PyTorch's current stream. Its source note says what bounds it
on the H100 and what the design does about that.

Its plain PyTorch version is `ops/panel._rank1_block_t`; `ops/panel
._rank1_dispatch` sends CPU tensors there and CUDA tensors here.
"""

from __future__ import annotations

import ctypes

import torch

from conflux_tpu_torch.ops import _build

# widest block the kernel takes (the JAX kernel's VMEM bound, kept as the
# interface limit: wider blocks run from global memory through the L2)
MAX_M = 65536

# launches of the kernel in this process; chip_smoke.py resets and reads it
LAUNCHES = 0

_lib = None


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load("rank1_panel")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.conflux_rank1_panel.argtypes = [p, p, p, p, p, p, p,
                                            i, i, i, i, p]
        lib.conflux_rank1_panel.restype = i
        lib.conflux_rank1_panel_scratch_floats.argtypes = [i]
        lib.conflux_rank1_panel_scratch_floats.restype = i
        lib.conflux_cuda_error_string.argtypes = [i]
        lib.conflux_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def rank1_block_t(Mt: torch.Tensor, avail_f: torch.Tensor,
                  forced: bool = False, j0: int = 0, finish: bool = False):
    """Fused masked-argmax rank-1 elimination of a TRANSPOSED block on the
    card. Mt [w, m] f32 (panel columns as rows); avail_f [1, m] f32
    (> 0 = selectable). Returns (Mt' [w, m], avail' [1, m], piv [w] i32,
    ok [w] i32), as `rank1_block_pallas_t` does.

    forced=True takes pivot j0 + jj for column jj instead of searching.
    `finish` is accepted for the caller's sake and changes nothing: the
    straight elimination leaves every pivot lane holding its merged-factor
    values in all modes (unforced callers never read them)."""
    global LAUNCHES
    del finish
    if not Mt.is_cuda or avail_f.device != Mt.device:
        raise ValueError("rank1_block_t takes CUDA tensors on one device")
    if Mt.dtype != torch.float32 or avail_f.dtype != torch.float32:
        raise TypeError("rank1_block_t takes float32 tensors")
    if Mt.dim() != 2 or tuple(avail_f.shape) != (1, Mt.shape[1]):
        raise ValueError(f"shapes Mt {tuple(Mt.shape)} and avail "
                         f"{tuple(avail_f.shape)} are not [w, m] and [1, m]")
    if not (Mt.is_contiguous() and avail_f.is_contiguous()):
        raise ValueError("rank1_block_t takes contiguous tensors")
    w, m = Mt.shape
    if not (1 <= w and 1 <= m <= MAX_M):
        raise ValueError(f"block [{w}, {m}] outside 1 <= m <= {MAX_M}")
    if forced and not 0 <= j0 <= m - w:
        raise ValueError(f"forced pivots {j0}..{j0 + w - 1} outside the "
                         f"{m} lanes")
    lib = _load()
    dev = Mt.device
    out = torch.empty_like(Mt)
    avail_o = torch.empty_like(avail_f)
    piv = torch.empty(w, dtype=torch.int32, device=dev)
    ok = torch.empty(w, dtype=torch.int32, device=dev)
    scratch = torch.empty(lib.conflux_rank1_panel_scratch_floats(w),
                          dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.conflux_rank1_panel(
            Mt.data_ptr(), avail_f.data_ptr(), out.data_ptr(),
            avail_o.data_ptr(), piv.data_ptr(), ok.data_ptr(),
            scratch.data_ptr(), w, m, int(forced), j0, stream)
    if err != 0:
        raise RuntimeError("rank1_panel launch failed: "
                           + lib.conflux_cuda_error_string(err).decode())
    LAUNCHES += 1
    return out, avail_o, piv, ok
