"""NCCL's device time per factorization on rank 0: the NCCL kernels of
the rank program's collectives and of the driver's closing all-reduce
(by kernel name). A collective's kernel runs until its peers reach it,
so the time holds the waits for the other ranks as well as the transfer.
The group holds each collective twice: its kernel and the device-side
annotation the profiler adds for c10d's user-scope range `nccl:<op>`
around it, which spans that one kernel (every collective of the program
launches one: a ppermute's send and receive go in one batch); so half
the group's time is the kernels'."""

from benchmark.trace import per_factor_ms

LAYER = "collectives (comm.Comm -> NCCL)"
UNIT = "ms"
SOURCE = "device_trace"
MOVES = "peak_gib"  # the cell holds the time per layer: factor_ms.p25d
GROUPS = ("NCCL collectives",)


def compute(s: dict):
    ms = per_factor_ms(s["trace"], GROUPS)
    return None if ms is None else ms / 2
