"""K3, K2 and K4 on Hopper: the matrix-product kernels, by hand in CUDA C++.

Counterpart of `conflux_tpu/ops/pallas_gemm.py`:
  * K3, `schur_update` (`schur_update_pallas`, kernels `_acc_kernel` and
    `_acc_kernel_x3`, split `_split_hi_lo`): csrc/schur_update.cu, a split
    pass and a wgmma + TMA product (csrc/wgmma_split.cuh);
  * K2, `sub_matmul_bigk` (`sub_matmul_pallas_bigk`, kernels
    `_acc_bigk_kernel` and `_acc_bigk_kernel_x3`): csrc/bigk_gemm.cu, the
    same split pass and wgmma + TMA product over (tile, K split) units,
    with a split-K sum where tiles are few;
  * K4, `matmul` (`matmul_pallas`, kernel `_mm_kernel`): csrc/bigk_gemm.cu.
Each source is built by `nvcc` for `sm_90a` at first use (ops/_build.py)
and called through ctypes on PyTorch's current stream. The source notes
say what bounds each kernel on the H100 and what its design does about
that.

Their plain PyTorch versions are `ops/gemm._schur_update_t`,
`_sub_matmul_bigk_t` and `_matmul_t`; the dispatchers in `ops/gemm` send
CPU tensors there and CUDA tensors here.
"""

from __future__ import annotations

import ctypes

import torch

from conflux_tpu_torch.ops import _build
from conflux_tpu_torch.ops.gemm import check_matmul, check_mode

# launches of each kernel in this process, one per wrapper call that
# launches it; chip_smoke.py resets and reads them
SCHUR_UPDATE_LAUNCHES = 0       # K3, every route
SCHUR_UPDATE_WGMMA_LAUNCHES = 0  # K3 split pass + wgmma (every call)
SUB_MATMUL_BIGK_LAUNCHES = 0    # K2 (its split-K sum included)
SUB_MATMUL_BIGK_WGMMA_LAUNCHES = 0  # K2 split pass + wgmma (every call)
MATMUL_LAUNCHES = 0             # K4, every route
MATMUL_WGMMA_LAUNCHES = 0       # K4 bf16 on TMA-aligned operands: wgmma
MATMUL_MMA_SYNC_LAUNCHES = 0    # K4 bf16 on other operands: mma.sync

# conflux_matmul's routes (bigk_gemm.cu, MatmulRoute); 0 is the f32 tile
_ROUTE_MMA_SYNC, _ROUTE_WGMMA = 1, 2
# conflux_schur_update's route (schur_update.cu, Route) and
# conflux_sub_matmul_bigk's (bigk_gemm.cu, BigkRoute)
_K3_ROUTE_WGMMA = 1
_K2_ROUTE_WGMMA = 1

_lib = None
_bigk_lib = None


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load("schur_update")
        p, i = ctypes.c_void_p, ctypes.c_int
        ll = ctypes.c_longlong
        lib.conflux_schur_update.argtypes = [p, i, i, p, i, p, i,
                                             i, i, i, i, p, ll, p,
                                             ctypes.POINTER(i)]
        lib.conflux_schur_update.restype = i
        lib.conflux_schur_update_workspace_bytes.argtypes = [i, i, i, i]
        lib.conflux_schur_update_workspace_bytes.restype = ll
        lib.conflux_split_hi_lo.argtypes = [p, i, i, i, p, p, i, p]
        lib.conflux_split_hi_lo.restype = i
        lib.conflux_schur_update_smem_bytes.argtypes = []
        lib.conflux_schur_update_smem_bytes.restype = i
        lib.conflux_schur_update_error_string.argtypes = [i]
        lib.conflux_schur_update_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _load_bigk() -> ctypes.CDLL:
    global _bigk_lib
    if _bigk_lib is None:
        lib = _build.load("bigk_gemm")
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.conflux_sub_matmul_bigk.argtypes = [p, i, p, i, i, p, i, p, i,
                                                i, i, i, i, i, p, ll, p,
                                                ctypes.POINTER(i)]
        lib.conflux_sub_matmul_bigk.restype = i
        lib.conflux_sub_matmul_bigk_workspace_bytes.argtypes = [i, i, i, i]
        lib.conflux_sub_matmul_bigk_workspace_bytes.restype = ll
        lib.conflux_sub_matmul_bigk_splits.argtypes = [i, i, i]
        lib.conflux_sub_matmul_bigk_splits.restype = i
        lib.conflux_sub_matmul_bigk_smem_bytes.argtypes = []
        lib.conflux_sub_matmul_bigk_smem_bytes.restype = i
        lib.conflux_matmul.argtypes = [p, i, p, i, p, i, i, i, i, i, p,
                                       ctypes.POINTER(i)]
        lib.conflux_matmul.restype = i
        lib.conflux_bigk_gemm_error_string.argtypes = [i]
        lib.conflux_bigk_gemm_error_string.restype = ctypes.c_char_p
        _bigk_lib = lib
    return _bigk_lib


def _check_2d(name: str, t: torch.Tensor, dev: torch.device):
    """A 2-D CUDA tensor on `dev` with unit column stride and a row stride
    that fits an int."""
    if not t.is_cuda or t.device != dev:
        raise ValueError(f"{name} must be a CUDA tensor on {dev}")
    if t.dim() != 2:
        raise ValueError(f"{name} must be 2-D, not {tuple(t.shape)}")
    if t.shape[1] > 1 and t.stride(1) != 1:
        raise ValueError(f"{name} needs unit column stride")
    if t.stride(0) >= 2 ** 31:
        raise ValueError(f"{name}'s row stride does not fit an int")


def schur_update(R: torch.Tensor, A: torch.Tensor, B: torch.Tensor, c0: int,
                 mode: str, c1: int | None = None) -> torch.Tensor:
    """R[:, c0:c1] -= A @ B on the card, in place; returns R.

    R [m, ncols] float32 ('high', 'bf16') or bfloat16 ('bf16out'),
    A [m, k] and B [k, c1 - c0] float32, all on one CUDA device with unit
    column stride (any row stride). The kernel first splits A and B into
    bf16 hi/lo copies in a workspace allocated here (freed into the
    caching allocator after the launch, which orders its reuse on this
    stream). An empty update launches nothing."""
    global SCHUR_UPDATE_LAUNCHES, SCHUR_UPDATE_WGMMA_LAUNCHES
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
        _check_2d(name, t, R.device)
    if m == 0 or k == 0 or c1 == c0:
        return R
    lib = _load()
    span = R[:, c0:c1]
    route = ctypes.c_int(-1)
    with torch.cuda.device(R.device):
        ws_bytes = lib.conflux_schur_update_workspace_bytes(m, c1 - c0, k,
                                                            passes)
        ws = torch.empty(ws_bytes, dtype=torch.uint8, device=R.device)
        stream = torch.cuda.current_stream(R.device).cuda_stream
        err = lib.conflux_schur_update(
            span.data_ptr(), int(mode == "bf16out"), R.stride(0),
            A.data_ptr(), A.stride(0), B.data_ptr(), B.stride(0),
            m, c1 - c0, k, passes, ws.data_ptr(), ws_bytes, stream,
            ctypes.byref(route))
    if err != 0:
        raise RuntimeError("schur_update launch failed: "
                           + lib.conflux_schur_update_error_string(err)
                           .decode())
    SCHUR_UPDATE_LAUNCHES += 1
    if route.value == _K3_ROUTE_WGMMA:
        SCHUR_UPDATE_WGMMA_LAUNCHES += 1
    return R


def split_hi_lo(x: torch.Tensor):
    """K3's split pass alone on a 2-D float32 CUDA tensor (unit column
    stride): (hi, lo) bf16 [rows, cols], views of copies whose row stride
    is padded to 8 elements, as the kernel writes its operands. For
    checking the pass against `ops/tri._split_hi_lo`; launches no product
    and counts no K3 launch."""
    if x.dtype != torch.float32:
        raise TypeError(f"split_hi_lo takes float32, not {x.dtype}")
    _check_2d("x", x, x.device)
    rows, cols = x.shape
    lds = (cols + 7) // 8 * 8
    hi = torch.empty((rows, lds), dtype=torch.bfloat16, device=x.device)
    lo = torch.empty_like(hi)
    if rows == 0 or cols == 0:
        return hi[:, :cols], lo[:, :cols]
    lib = _load()
    with torch.cuda.device(x.device):
        err = lib.conflux_split_hi_lo(
            x.data_ptr(), x.stride(0), rows, cols, hi.data_ptr(),
            lo.data_ptr(), lds, torch.cuda.current_stream(x.device)
            .cuda_stream)
    if err != 0:
        raise RuntimeError("split_hi_lo launch failed: "
                           + lib.conflux_schur_update_error_string(err)
                           .decode())
    return hi[:, :cols], lo[:, :cols]


def sub_matmul_bigk_splits(m: int, n: int, k: int) -> int:
    """How many K splits K2 takes for an [m, n] output and depth k on the
    current card (1: no split-K, no partial products)."""
    return _load_bigk().conflux_sub_matmul_bigk_splits(m, n, k)


def sub_matmul_bigk(R: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
                    mode: str) -> torch.Tensor:
    """R - A @ B on the card, as a new tensor of R's dtype; R is read only.

    R [m, n] float32 ('high', 'bf16') or bfloat16 ('bf16out'), A [m, k]
    and B [k, n] float32, all on one CUDA device with unit column stride
    (any row stride); B may instead have unit row stride, a transposed
    view such as `F[k:k+w, :k].T`. The kernel first splits A and B into
    bf16 hi/lo copies in a workspace allocated here, which also holds
    split-K's partial products where K splits. With k = 0 the result is a
    copy of R and nothing is launched."""
    global SUB_MATMUL_BIGK_LAUNCHES, SUB_MATMUL_BIGK_WGMMA_LAUNCHES
    passes = check_mode(R, mode)
    if A.dtype != torch.float32 or B.dtype != torch.float32:
        raise TypeError(f"A and B must be float32, not {A.dtype}, {B.dtype}")
    # B stored transposed: unit row stride, read in place by the split pass
    b_trans = (B.dim() == 2 and B.shape[1] > 1 and B.stride(1) != 1
               and B.stride(0) == 1)
    for name, t in (("R", R), ("A", A), ("B", B.T if b_trans else B)):
        _check_2d(name, t, R.device)
    m, n = R.shape
    k = A.shape[1]
    if tuple(A.shape) != (m, k) or tuple(B.shape) != (k, n):
        raise ValueError(f"shapes R {tuple(R.shape)}, A {tuple(A.shape)}, "
                         f"B {tuple(B.shape)} do not fit R - A @ B")
    if max(m, n, k) >= 2 ** 31:
        raise ValueError("a dimension does not fit an int")
    out = torch.empty((m, n), dtype=R.dtype, device=R.device)
    if m == 0 or n == 0:
        return out
    if k == 0:
        return out.copy_(R)
    lib = _load_bigk()
    route = ctypes.c_int(-1)
    with torch.cuda.device(R.device):
        # freed into the caching allocator after the launch, which orders
        # its reuse on this stream
        ws_bytes = lib.conflux_sub_matmul_bigk_workspace_bytes(m, n, k,
                                                               passes)
        ws = torch.empty(ws_bytes, dtype=torch.uint8, device=R.device)
        stream = torch.cuda.current_stream(R.device).cuda_stream
        err = lib.conflux_sub_matmul_bigk(
            R.data_ptr(), R.stride(0), out.data_ptr(), out.stride(0),
            int(mode == "bf16out"), A.data_ptr(), A.stride(0),
            B.data_ptr(), B.stride(1 if b_trans else 0), int(b_trans), m, n,
            k, passes, ws.data_ptr(), ws_bytes, stream, ctypes.byref(route))
    if err != 0:
        raise RuntimeError("sub_matmul_bigk launch failed: "
                           + lib.conflux_bigk_gemm_error_string(err)
                           .decode())
    SUB_MATMUL_BIGK_LAUNCHES += 1
    if route.value == _K2_ROUTE_WGMMA:
        SUB_MATMUL_BIGK_WGMMA_LAUNCHES += 1
    return out


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C = a @ b on the card with a float32 result: a [m, k] and b [k, n]
    both float32 (IEEE fp32 FMA products) or both bfloat16 (tensor cores,
    fp32 accumulation), on one CUDA device with unit column stride (any
    row stride). bf16 operands with 16-byte-aligned bases and row strides
    that are multiples of 8 take the wgmma + TMA kernel, others the
    mma.sync one; the kernel chooses and reports the route. With k = 0 the
    result is zeros and nothing is launched."""
    global MATMUL_LAUNCHES, MATMUL_WGMMA_LAUNCHES, MATMUL_MMA_SYNC_LAUNCHES
    check_matmul(a, b)
    _check_2d("a", a, a.device)
    _check_2d("b", b, a.device)
    m, k = a.shape
    n = b.shape[1]
    if max(m, n, k) >= 2 ** 31:
        raise ValueError("a dimension does not fit an int")
    if m == 0 or n == 0 or k == 0:
        return torch.zeros((m, n), dtype=torch.float32, device=a.device)
    c = torch.empty((m, n), dtype=torch.float32, device=a.device)
    lib = _load_bigk()
    route = ctypes.c_int(-1)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = lib.conflux_matmul(
            a.data_ptr(), a.stride(0), b.data_ptr(), b.stride(0),
            c.data_ptr(), c.stride(0), m, n, k,
            int(a.dtype == torch.bfloat16), stream, ctypes.byref(route))
    if err != 0:
        raise RuntimeError("matmul launch failed: "
                           + lib.conflux_bigk_gemm_error_string(err)
                           .decode())
    MATMUL_LAUNCHES += 1
    if route.value == _ROUTE_WGMMA:
        MATMUL_WGMMA_LAUNCHES += 1
    elif route.value == _ROUTE_MMA_SYNC:
        MATMUL_MMA_SYNC_LAUNCHES += 1
    return c
