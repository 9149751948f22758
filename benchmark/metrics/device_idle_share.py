"""The device's idle share: 1 - device busy per factorization (the
union of the traced device events over the factorizations traced) over
the wall per factorization of the same run's unprofiled window."""

LAYER = "device"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "factor_ms"


def compute(s: dict):
    t = s["trace"]
    if t["busy_s"] <= 0:
        return None
    busy_ms = 1e3 * t["busy_s"] / t["count"]
    return 100.0 * (1.0 - busy_ms / s["factor_ms"])
