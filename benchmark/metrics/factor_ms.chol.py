"""The window's time per factorization (run.py's `factor_ms`) as a
per-layer metric, in the cells whose runs spread too widely for it to be
held end to end (chol.n32768: the host-bound step loop follows the host
CPU's speed; PERF.md §2). It moves the time, which that cell reports
nowhere end to end; its entry names the one it does report."""

LAYER = "entry points"
UNIT = "ms"
SOURCE = "host_clock"
MOVES = "peak_gib"


def compute(s: dict):
    return s["factor_ms"]
