"""The fused trailing update R[:, c0:c1] -= A @ B (K3).

PyTorch counterpart of `conflux_tpu/ops/pallas_gemm.py`'s
`schur_update_pallas`. CUDA tensors go to the hand-written kernel
(ops/cuda_gemm.py, csrc/schur_update.cu); CPU tensors go to the plain
version `_schur_update_t`; there is no fallback between the two.

Modes are the TPU kernel's: 'high' (bf16x3: hi*hi + hi*lo + lo*hi with
fp32 accumulation), 'bf16' (one bf16 pass, fp32 accumulation) on a float32
R, and 'bf16out' (one pass into a bfloat16 R). 'highest' has no kernel, as
on the TPU: callers run IEEE fp32 `torch.mm` for it.
"""

from __future__ import annotations

import torch

from conflux_tpu_torch.ops.tri import schur_dot

# mode -> (R's dtype, bf16 products per operand chunk: hi*hi, hi*lo, lo*hi
# for 'high', hi*hi for the others); the plain version and the kernel's
# wrapper both check their arguments against it
MODES = {"high": (torch.float32, 3), "bf16": (torch.float32, 1),
         "bf16out": (torch.bfloat16, 1)}


def check_mode(R: torch.Tensor, mode: str) -> int:
    """Raise unless `mode` is one of MODES and R has its dtype; returns
    the mode's number of bf16 products."""
    if mode not in MODES:
        raise ValueError(f"schur_update has no mode {mode!r} ('highest' "
                         "runs as IEEE fp32 torch.mm at the caller)")
    dtype, passes = MODES[mode]
    if R.dtype != dtype:
        raise TypeError(f"mode {mode!r} updates a {dtype} R, not {R.dtype}")
    return passes


def _schur_update_t(R: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
                    c0: int, mode: str, c1: int | None = None) -> torch.Tensor:
    """Plain version of K3, in place: the TPU kernel's arithmetic
    (pallas_gemm.py:92, :109), an fp32 product, one fp32 subtraction and
    one rounding into R's dtype."""
    check_mode(R, mode)
    c1 = R.shape[1] if c1 is None else c1
    S = schur_dot(A, B, "bf16" if mode == "bf16out" else mode)
    R[:, c0:c1] = (R[:, c0:c1].float() - S).to(R.dtype)
    return R


def schur_update(R: torch.Tensor, A: torch.Tensor, B: torch.Tensor, c0: int,
                 mode: str, c1: int | None = None) -> torch.Tensor:
    """R[:, c0:c1] -= A @ B in place (c1 defaults to R's width); returns R.
    R float32 for 'high'/'bf16', bfloat16 for 'bf16out'; A [m, k] and
    B [k, c1 - c0] float32."""
    if R.is_cuda:
        from conflux_tpu_torch.ops.cuda_gemm import schur_update as k3

        return k3(R, A, B, c0, mode, c1)
    if R.device.type == "cpu":
        return _schur_update_t(R, A, B, c0, mode, c1)
    raise ValueError(f"no trailing-update kernel for device {R.device}")
