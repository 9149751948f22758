"""Device idle under the step loops' own Python: ms per traced
factorization of the device's idle gaps whose innermost open host event
is one of the program's phase spans (`profiler.span`: lu.factor,
lu.update, lu.panel, lu.solve, lu.compact; chol.*), i.e. idle while the
step loop ran Python between torch ops inside a span. Read from the
trace summary's top `trace.TOP` idle gaps: where that list is full and
names no span, a span's idle may lie beyond the cut, and nothing is
read."""

from benchmark import trace

LAYER = "drivers"
UNIT = "ms"
SOURCE = "device_trace"
MOVES = "factor_ms"

SPANS = ("lu.", "chol.")


def compute(s: dict):
    t = s["trace"]
    gaps = t["idle_gaps"]
    idle = [sec for name, sec in gaps if name.startswith(SPANS)]
    if not idle and len(gaps) >= trace.TOP:
        return None
    return 1e3 * sum(idle) / t["count"]
