"""Kernel launches per factorization: the device kernels in the trace
(copies and fills left out) over the factorizations traced. A count of
the driver's step loop."""

LAYER = "drivers"
UNIT = "launches"
SOURCE = "device_trace"
MOVES = "factor_ms"


def compute(s: dict):
    t = s["trace"]
    return t["kernels"] / t["count"] if t["kernels"] else None
