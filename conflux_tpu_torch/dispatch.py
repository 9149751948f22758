"""Rank-program variant dispatch — the analog of the reference's
(P, N)-keyed `parallelCholesky` variant table
(src/conflux/cholesky/Cholesky.cpp:857-921).

A copy of `conflux_tpu/dispatch.py:62-143`: the variant names, the
selection rule and the window segmentation. The rule and its thresholds
were measured on a TPU (v5e); the port keeps them until the card's own
numbers say otherwise. The JAX package has five rank programs per
algorithm because 'fori' and 'windowed' bound XLA's trace size; eager
PyTorch has no trace, so the port runs one right-looking program per
algorithm whose steps slice their exact live window, plus Cholesky's
left-looking 'crout' (lu/p25d.py, cholesky/p25d.py say what each name
means there).
"""

from __future__ import annotations

from typing import List, Tuple

VARIANTS = ("fori", "unrolled", "windowed", "lookahead", "crout")

# Max modeled comm premium (crout total volume / rightlook total volume,
# spec.model_comm_volume) the LU crout variant is allowed before the
# dispatch falls back to windowed: only essentially premium-free grids
# (P = 1) qualify.
LU_CROUT_COMM_PREMIUM = 1.2

# Step count past which the JAX package replaces every Python-unrolled
# variant by the windowed one (its trace and compile time); kept so the
# auto choice names the same variant as the reference.
MAX_UNROLLED_STEPS = {"lu": 256, "cholesky": 256}


def _lu_crout_grid_ok(desc) -> bool:
    """Grid gate for the LU crout variant: modeled comm premium vs the
    right-looking schedule stays under LU_CROUT_COMM_PREMIUM (P == 1 is
    premium-free by definition — no collective moves any bytes)."""
    g = desc.grid
    if g.P == 1:
        return True
    from conflux_tpu_torch.spec import model_comm_volume

    c = model_comm_volume(desc.N, desc.v, g.Px, Pz=g.Pz, Py=g.Py,
                          variant="crout").total()
    r = model_comm_volume(desc.N, desc.v, g.Px, Pz=g.Pz, Py=g.Py,
                          variant="rightlook").total()
    return c <= LU_CROUT_COMM_PREMIUM * r


def choose_variant(desc, algorithm: str = "cholesky") -> str:
    """Pick the rank-program variant for a problem descriptor, keyed on
    both the problem size and the grid (through the comm model)."""
    if desc.Nt > MAX_UNROLLED_STEPS[algorithm]:
        return "windowed"
    if algorithm == "lu":
        if desc.N < 8192:
            return "fori"
        if desc.N >= 16384 and _lu_crout_grid_ok(desc):
            return "crout"
        return "windowed"
    return "lookahead" if desc.N < 8192 else "crout"


def normalize_variant(unroll, desc, algorithm: str) -> str:
    """Map the public `unroll` argument (None | bool | variant name) to a
    variant name. None auto-selects; the bools keep the round-1 API."""
    if unroll is None:
        return choose_variant(desc, algorithm)
    if unroll is True:
        return "unrolled"
    if unroll is False:
        return "fori"
    if unroll in VARIANTS:
        return unroll
    raise ValueError(f"unknown variant {unroll!r}; expected None, bool or "
                     f"one of {VARIANTS}")


def segment_bounds(Nt: int, windows: int) -> List[Tuple[int, int]]:
    """Split steps [0, Nt) into <= `windows` contiguous segments of
    near-equal size: the window boundaries of the windowed variant."""
    w = max(1, min(windows, Nt))
    chunk = -(-Nt // w)  # ceil
    return [(lo, min(lo + chunk, Nt)) for lo in range(0, Nt, chunk)]
