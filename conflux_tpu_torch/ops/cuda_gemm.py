"""K3 on Hopper: the fused trailing update, by hand in CUDA C++.

Counterpart of `conflux_tpu/ops/pallas_gemm.py` (`schur_update_pallas`,
kernels `_acc_kernel` and `_acc_kernel_x3`). The kernel is
`csrc/schur_update.cu`, built by `nvcc` for `sm_90a` at first use
(ops/_build.py) and called through ctypes on PyTorch's current stream. Its
source note says what bounds it on the H100 and what the design does about
that.

Its plain PyTorch version is `ops/gemm._schur_update_t`; `ops/gemm
.schur_update` sends CPU tensors there and CUDA tensors here.
"""

from __future__ import annotations

import ctypes

import torch

from conflux_tpu_torch.ops import _build
from conflux_tpu_torch.ops.gemm import check_mode

# launches of the kernel in this process; chip_smoke.py resets and reads it
LAUNCHES = 0

_lib = None


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load("schur_update")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.conflux_schur_update.argtypes = [p, i, i, p, i, p, i,
                                             i, i, i, i, p]
        lib.conflux_schur_update.restype = i
        lib.conflux_schur_update_smem_bytes.argtypes = []
        lib.conflux_schur_update_smem_bytes.restype = i
        lib.conflux_schur_update_error_string.argtypes = [i]
        lib.conflux_schur_update_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def schur_update(R: torch.Tensor, A: torch.Tensor, B: torch.Tensor, c0: int,
                 mode: str, c1: int | None = None) -> torch.Tensor:
    """R[:, c0:c1] -= A @ B on the card, in place; returns R.

    R [m, ncols] float32 ('high', 'bf16') or bfloat16 ('bf16out'),
    A [m, k] and B [k, c1 - c0] float32, all on one CUDA device with unit
    column stride (any row stride). An empty update launches nothing."""
    global LAUNCHES
    passes = check_mode(R, mode)
    if not (R.is_cuda and A.device == R.device and B.device == R.device):
        raise ValueError("schur_update takes CUDA tensors on one device")
    if A.dtype != torch.float32 or B.dtype != torch.float32:
        raise TypeError(f"A and B must be float32, not {A.dtype}, {B.dtype}")
    if R.dim() != 2 or A.dim() != 2 or B.dim() != 2:
        raise ValueError("schur_update takes 2-D tensors")
    m, ncols = R.shape
    c1 = ncols if c1 is None else c1
    k = A.shape[1]
    if not 0 <= c0 <= c1 <= ncols:
        raise ValueError(f"span [{c0}, {c1}) outside R's {ncols} columns")
    if tuple(A.shape) != (m, k) or tuple(B.shape) != (k, c1 - c0):
        raise ValueError(f"shapes R {tuple(R.shape)}, A {tuple(A.shape)}, "
                         f"B {tuple(B.shape)} do not fit the span "
                         f"[{c0}, {c1})")
    for name, t in (("R", R), ("A", A), ("B", B)):
        if t.shape[1] > 1 and t.stride(1) != 1:
            raise ValueError(f"{name} needs unit column stride")
        if t.stride(0) >= 2 ** 31:
            raise ValueError(f"{name}'s row stride does not fit an int")
    if m == 0 or k == 0 or c1 == c0:
        return R
    lib = _load()
    span = R[:, c0:c1]
    with torch.cuda.device(R.device):
        stream = torch.cuda.current_stream(R.device).cuda_stream
        err = lib.conflux_schur_update(
            span.data_ptr(), int(mode == "bf16out"), R.stride(0),
            A.data_ptr(), A.stride(0), B.data_ptr(), B.stride(0),
            m, c1 - c0, k, passes, stream)
    if err != 0:
        raise RuntimeError("schur_update launch failed: "
                           + lib.conflux_schur_update_error_string(err)
                           .decode())
    LAUNCHES += 1
    return R
