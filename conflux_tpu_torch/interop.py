"""The state that crosses between the JAX package and this one.

The system holds no parameters: what crosses is the input matrix A and
the factor (F, perm) with A[perm] = unit_lower(F) @ upper(F). Both
packages take and give numpy arrays at this boundary.
"""

from __future__ import annotations

import numpy as np
import torch


def from_numpy(A, device="cuda") -> torch.Tensor:
    """numpy (or anything array-like) -> float32 tensor on `device`: the
    card unless the caller asks for the CPU. Without a card the default
    raises torch's own error; nothing falls back to the CPU."""
    return torch.as_tensor(np.asarray(A, np.float32), device=device)


def factors_to_numpy(F: torch.Tensor, perm: torch.Tensor):
    """(F, perm) tensors -> (F float32, perm int64) numpy arrays."""
    return (F.detach().cpu().numpy().astype(np.float32, copy=False),
            perm.detach().cpu().numpy().astype(np.int64, copy=False))
