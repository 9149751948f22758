"""Whole-row movement at dynamic row indices: the in-place row scatter (K5)
and the row gather (K6).

PyTorch counterpart of `conflux_tpu/ops/pallas_scatter.py`
(`scatter_rows`, `gather_rows`). CUDA tensors go to the hand-written
kernels (ops/cuda_scatter.py, csrc/row_move.cu); CPU tensors go to the
plain versions `_scatter_rows_t` (`index_copy_`) and `_gather_rows_t`
(`index_select`); there is no fallback between the two. float32 or
bfloat16, any row width and any row stride. The TPU's `group` argument
and its `n % 128` and `w % group` gates exist for Mosaic's DMA
descriptors and have no counterpart here.
"""

from __future__ import annotations

import torch


def check_rows(R: torch.Tensor, index: torch.Tensor,
               src: torch.Tensor | None = None):
    """Raise unless R is a 2-D float32/bfloat16 tensor, index a 1-D int64
    tensor on R's device and src (for a scatter) [len(index), R's width] of
    R's dtype."""
    if R.dim() != 2 or R.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError("row moves take a 2-D float32 or bfloat16 tensor, "
                        f"not {R.dtype} of shape {tuple(R.shape)}")
    if index.dim() != 1 or index.dtype != torch.int64:
        raise TypeError("row indices must be a 1-D int64 tensor")
    if index.device != R.device:
        raise ValueError("row indices must lie on R's device")
    if src is not None and (src.dtype != R.dtype or tuple(src.shape)
                            != (index.shape[0], R.shape[1])):
        raise ValueError(f"src {src.dtype} {tuple(src.shape)} does not fit "
                         f"{index.shape[0]} rows of R {R.dtype} "
                         f"{tuple(R.shape)}")


def _scatter_rows_t(R: torch.Tensor, src: torch.Tensor,
                    slots: torch.Tensor) -> torch.Tensor:
    """Plain version of K5: R[slots[i]] = src[i], in place; returns R."""
    check_rows(R, slots, src)
    return R.index_copy_(0, slots, src)


def _gather_rows_t(R: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain version of K6: out[i] = R[idx[i]], a fresh tensor."""
    check_rows(R, idx)
    return R.index_select(0, idx)


def scatter_rows(R: torch.Tensor, src: torch.Tensor,
                 slots: torch.Tensor) -> torch.Tensor:
    """R[slots[i], :] = src[i, :], in place; returns R. The slots must be
    unique and in [0, m), and src must not overlap R. There is no masking:
    a pair that should do nothing is written as a self-write,
    src[i] == R[slots[i]]."""
    if R.is_cuda:
        from conflux_tpu_torch.ops.cuda_scatter import scatter_rows as k5

        return k5(R, src, slots)
    if R.device.type == "cpu":
        return _scatter_rows_t(R, src, slots)
    raise ValueError(f"no row-scatter kernel for device {R.device}")


def gather_rows(R: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[i, :] = R[idx[i], :] into a fresh contiguous tensor; idx entries
    in [0, m)."""
    if R.is_cuda:
        from conflux_tpu_torch.ops.cuda_scatter import gather_rows as k6

        return k6(R, idx)
    if R.device.type == "cpu":
        return _gather_rows_t(R, idx)
    raise ValueError(f"no row-gather kernel for device {R.device}")
