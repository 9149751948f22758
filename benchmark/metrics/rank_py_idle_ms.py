"""Device idle under the rank program's own Python: ms per traced
factorization of the device's idle gaps whose innermost open host event
is one of `lu_25d`'s spans (lu25d.factor and its substeps
lu25d.step0_reduce ... lu25d.step6_update), i.e. idle while rank 0's
rank program ran Python between torch ops and outside any collective.
Read from the trace summary's top `trace.TOP` idle gaps: where that list is
full and names no such span (a program without the spans, or spans whose
idle lies beyond the cut), nothing is read."""

from benchmark import trace

LAYER = "rank programs (lu.p25d)"
UNIT = "ms"
SOURCE = "device_trace"
MOVES = "peak_gib"  # the cell holds the time per layer: factor_ms.p25d
SPANS = ("lu25d.",)


def compute(s: dict):
    t = s["trace"]
    gaps = t["idle_gaps"]
    idle = [sec for name, sec in gaps if name.startswith(SPANS)]
    if not idle and len(gaps) >= trace.TOP:
        return None
    return 1e3 * sum(idle) / t["count"]
