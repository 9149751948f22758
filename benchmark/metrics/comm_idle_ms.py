"""Device idle under the collectives' host work: ms per traced
factorization of the device's idle gaps whose innermost open host event
is a `comm.*` span (comm.Comm's psum, all_gather, ppermute,
psum_scatter, gather, all_to_all) or c10d's own host work inside one
(`record_param_comms`, `c10d::*` ops, the `nccl:<op>` ranges), i.e. idle
while rank 0's host ran a collective rather than the rank program. Read
from the trace summary's top `trace.TOP` idle gaps, so it is a lower
bound that moves as gaps of its kind enter or leave that list; where the
list is full and names none of them, nothing is read."""

from benchmark import trace

LAYER = "collectives (comm.Comm -> NCCL)"
UNIT = "ms"
SOURCE = "device_trace"
MOVES = "peak_gib"  # the cell holds the time per layer: factor_ms.p25d
SPANS = ("comm.", "record_param_comms", "c10d::", "nccl:")


def compute(s: dict):
    t = s["trace"]
    gaps = t["idle_gaps"]
    idle = [sec for name, sec in gaps if name.startswith(SPANS)]
    if not idle and len(gaps) >= trace.TOP:
        return None
    return 1e3 * sum(idle) / t["count"]
