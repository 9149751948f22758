"""The state that crosses between the JAX package and this one.

The system holds no parameters: what crosses is the input matrix A and
the factor (F, perm) with A[perm] = unit_lower(F) @ upper(F). Both
packages take and give numpy arrays at this boundary. numpy has no
bfloat16 of its own: a bf16 tensor is made from the float32 array,
rounded by torch (as `jnp.asarray(A, jnp.bfloat16)` rounds it in the JAX
package); a host array that is already bfloat16 (`ml_dtypes.bfloat16`,
the JAX package's host type) crosses by its bits; and a bf16 factor
leaves as float32, which holds its values exactly.
"""

from __future__ import annotations

import numpy as np
import torch


def host_tensor(A) -> torch.Tensor:
    """numpy (or anything array-like) -> a CPU tensor that shares its
    memory where torch can. `torch.from_numpy` refuses an
    `ml_dtypes.bfloat16` array, so such an array crosses as its uint16
    bits, viewed as torch.bfloat16."""
    a = np.asarray(A)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.as_tensor(a)


def from_numpy(A, device="cuda", dtype=torch.float32) -> torch.Tensor:
    """numpy (or anything array-like) -> tensor of `dtype` on `device`:
    the card unless the caller asks for the CPU. bfloat16 from a wider
    array is that array rounded to nearest even by torch; a bfloat16 host
    array keeps its bits. Without a card the default raises torch's own
    error; nothing falls back to the CPU."""
    a = np.asarray(A)
    if dtype == torch.bfloat16 and a.dtype.name != "bfloat16":
        a = a.astype(np.float32, copy=False)
    return host_tensor(a).to(device=device, dtype=dtype)


def factors_to_numpy(F: torch.Tensor, perm: torch.Tensor):
    """(F, perm) tensors -> (F, perm int64) numpy arrays. F keeps float32,
    float64, complex64 and complex128; a bfloat16 F comes back as
    float32."""
    F = F.detach()
    if F.dtype == torch.bfloat16:
        F = F.float()
    return (F.cpu().numpy(),
            perm.detach().cpu().numpy().astype(np.int64, copy=False))


def resolve_device(device) -> torch.device:
    """`device` with its index filled in ('cuda' -> the current card), so
    that two names of one device compare equal. 'cuda' without a card
    raises torch's own error."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
