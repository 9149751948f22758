"""The matrix-product kernels: the fused trailing update
R[:, c0:c1] -= A @ B (K3), the big-K R - A @ B (K2) and the plain
C = A @ B (K4).

PyTorch counterpart of `conflux_tpu/ops/pallas_gemm.py`
(`schur_update_pallas`, `sub_matmul_pallas_bigk`, `matmul_pallas`). CUDA
tensors go to the hand-written kernels (ops/cuda_gemm.py,
csrc/schur_update.cu and csrc/bigk_gemm.cu); CPU tensors go to the plain
versions `_schur_update_t`, `_sub_matmul_bigk_t` and `_matmul_t`; there is
no fallback between the two. Any shape and any row stride: the TPU's
divisibility asserts have no counterpart.

Modes of K3 and K2 are the TPU kernels': 'high' (bf16x3: hi*hi + hi*lo +
lo*hi with fp32 accumulation), 'bf16' (one bf16 pass, fp32 accumulation)
on a float32 R, and 'bf16out' (one pass into a bfloat16 R). 'highest' has
no kernel: callers run IEEE fp32 `torch.mm` for it. (The JAX
`sub_matmul_pallas_bigk` runs 'highest' silently as 'high'; the port
rejects it.)
"""

from __future__ import annotations

import torch

from conflux_tpu_torch.ops.tri import schur_dot

# the products `sub_dot` formed on a float64 R (cuBLAS's on the card): one
# IEEE f64 `torch.mm` each in 'highest' and 'high', one bf16 pass in 'bf16'
SUB_DOT_F64_PRODUCTS = 0

# mode -> (R's dtype, bf16 products per operand chunk: hi*hi, hi*lo, lo*hi
# for 'high', hi*hi for the others); the plain version and the kernel's
# wrapper both check their arguments against it
MODES = {"high": (torch.float32, 3), "bf16": (torch.float32, 1),
         "bf16out": (torch.bfloat16, 1)}


def check_mode(R: torch.Tensor, mode: str) -> int:
    """Raise unless `mode` is one of MODES and R has its dtype; returns
    the mode's number of bf16 products."""
    if mode not in MODES:
        raise ValueError(f"no kernel mode {mode!r} ('highest' runs as "
                         "IEEE fp32 torch.mm at the caller)")
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


def _sub_matmul_bigk_t(R: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
                       mode: str) -> torch.Tensor:
    """Plain version of K2: the TPU kernel's arithmetic (pallas_gemm.py:147,
    :172), an fp32 product, one fp32 subtraction and one rounding into R's
    dtype, into a new tensor."""
    check_mode(R, mode)
    S = schur_dot(A, B, "bf16" if mode == "bf16out" else mode)
    return (R.float() - S).to(R.dtype)


def sub_matmul_bigk(R: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
                    mode: str) -> torch.Tensor:
    """R - A @ B as a new tensor of R's dtype, for any K: R [m, n] float32
    for 'high'/'bf16', bfloat16 for 'bf16out'; A [m, k] and B [k, n]
    float32, or both bfloat16 in 'bf16'/'bf16out' (bf16 storage's
    operands: on the card K2's bf16-operand entry, which reads them in
    place). R is not modified."""
    if R.is_cuda:
        from conflux_tpu_torch.ops import cuda_gemm

        k2 = (cuda_gemm.sub_matmul_bigk_bf16 if A.dtype == torch.bfloat16
              else cuda_gemm.sub_matmul_bigk)
        return k2(R, A, B, mode)
    if R.device.type == "cpu":
        return _sub_matmul_bigk_t(R, A, B, mode)
    raise ValueError(f"no big-K kernel for device {R.device}")


def sub_dot(R: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
            precision: str) -> torch.Tensor:
    """R - A @ B as a new tensor in a driver's `precision`: K2
    (`sub_matmul_bigk`) in 'high' and 'bf16' on a float32 R (A and B
    float32, or bfloat16 in 'bf16'), whose plain version is
    `R - schur_dot(A, B, precision)` bit for bit; that expression itself in
    'highest' (IEEE fp32 `torch.mm`), 'bf16out' (the product rounded to
    bf16 first, as the JAX drivers form it) and on a float64 R, counted
    in SUB_DOT_F64_PRODUCTS: in 'highest' and 'high' one IEEE f64
    `torch.mm`, as the JAX package's x64 mode runs it; in 'bf16' the f64
    operands rounded to bf16, one pass with fp32 accumulation."""
    global SUB_DOT_F64_PRODUCTS
    if precision in ("high", "bf16") and R.dtype == torch.float32:
        return sub_matmul_bigk(R, A, B, precision)
    if R.dtype == torch.float64:
        SUB_DOT_F64_PRODUCTS += 1
    return R - schur_dot(A, B, precision)


def check_matmul(a: torch.Tensor, b: torch.Tensor):
    """Raise unless a [m, k] and b [k, n] are both float32 or both
    bfloat16."""
    if a.dtype != b.dtype or a.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError("matmul takes two float32 or two bfloat16 tensors, "
                        f"not {a.dtype} and {b.dtype}")
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"matmul of shapes {tuple(a.shape)} and "
                         f"{tuple(b.shape)}")


def _matmul_t(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version of K4: IEEE fp32 products of the operands' values
    (products of bf16 values are exact in fp32, so for bf16 operands only
    the summation order differs from the kernel's)."""
    check_matmul(a, b)
    return torch.mm(a.float(), b.float())


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C = a @ b with a float32 result; a and b both float32 (IEEE fp32
    products) or both bfloat16 (fp32 accumulation)."""
    if a.is_cuda:
        from conflux_tpu_torch.ops.cuda_gemm import matmul as k4

        return k4(a, b)
    if a.device.type == "cpu":
        return _matmul_t(a, b)
    raise ValueError(f"no matmul kernel for device {a.device}")
