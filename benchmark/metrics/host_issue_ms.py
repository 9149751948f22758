"""Host issue time per factorization: the host clock from the call into
the entry point to its return, before the synchronize (the Python step
loop's enqueue work), averaged over the unprofiled window."""

LAYER = "entry points"
UNIT = "ms"
SOURCE = "host_clock"
MOVES = "factor_ms"


def compute(s: dict):
    return s["host_issue_ms"]
