"""The benchmark's input matrices, made on the device from the seed.

Each generator is named in a configuration's "input" entry, with its
parameters, and makes input j of a run from (seed, j) alone, so the
harness and the reference can each make the same matrix, and the same
seed gives the same inputs. Frozen copies of the upstream generators as
the port's `io` module documents them (conflux_tpu_torch/io.py:26-78 at
commit 6687417), written for the card: one matrix in a few large calls,
in the dtype it is factored in.
"""

from __future__ import annotations

import torch

_MASK = (1 << 63) - 1


def input_seed(seed: int, j: int) -> int:
    """The generator seed of input j of a run: distinct for every (seed,
    j) a run uses, for any seed up to 2**63."""
    return (seed * 0x9E3779B97F4A7C15 + (j + 1) * 0xBF58476D1CE4E5B9) & _MASK


def uniform(n: int, gen: torch.Generator, device, low: float, high: float,
            dtype=torch.float32) -> torch.Tensor:
    """low + (high - low) U[0, 1): CONFLUX's benchmark fill 5 + U[0, 1)
    (lu_params.hpp:364-375 in the upstream) with low = 5, high = 6."""
    A = torch.rand(n, n, generator=gen, device=device, dtype=dtype)
    return A.mul_(high - low).add_(low)


def confchox_spd(n: int, gen: torch.Generator, device, tile: int,
                 dtype=torch.float32) -> torch.Tensor:
    """CONFCHOX's SPD fill (CholeskyIO.cpp:100-172 in the upstream): a
    seeded [tile, tile] Gram tile G = R R^T / tile, symmetrised and
    replicated over the matrix, and G[a, a] + 2 tile on the diagonal."""
    R = torch.randn(tile, tile, generator=gen, device=device,
                    dtype=torch.float64)
    G = (R @ R.T) / tile
    reps = -(-n // tile)
    A = ((G + G.T) / 2).to(dtype).repeat(reps, reps)[:n, :n].contiguous()
    d = torch.arange(n, device=device)
    A[d, d] = (torch.diagonal(G)[d % tile] + 2.0 * tile).to(dtype)
    return A


GENERATORS = {"uniform": uniform, "confchox_spd": confchox_spd}


def make(spec: dict, n: int, seed: int, j: int, device) -> torch.Tensor:
    """Input j of a run with `seed`, by the configuration's input spec
    {"generator": name, **parameters}."""
    params = dict(spec)
    fn = GENERATORS[params.pop("generator")]
    gen = torch.Generator(device=device).manual_seed(input_seed(seed, j))
    return fn(n, gen, device, **params)
