"""NCCL kernels per factorization on rank 0: the collectives that
reached the device (a collective over a group of one rank launches
none). The group counts each collective twice, its kernel and the
profiler's device-side annotation of c10d's `nccl:<op>` range around it
(nccl_ms.py), so the kernels are half its events."""

LAYER = "collectives (comm.Comm -> NCCL)"
UNIT = "launches"
SOURCE = "device_trace"
MOVES = "peak_gib"  # the cell holds the time per layer: factor_ms.p25d
GROUP = "NCCL collectives"


def compute(s: dict):
    t = s["trace"]
    g = t["groups"].get(GROUP)
    return g["launches"] / 2 / t["count"] if g and g["launches"] else None
