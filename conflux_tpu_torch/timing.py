"""Device timing with CUDA events.

PyTorch counterpart of `conflux_tpu/timing.py`. Work is enqueued on the
current stream between two events and timed by the device itself; the JAX
package's scalar-readback completion fence has no counterpart here.
Timing needs a card: with none these functions raise instead of timing
the CPU, unless the caller asks for the host's clock (device='cpu').
"""

from __future__ import annotations

import statistics
import time
from typing import Callable, List, Tuple

import torch


def timed_run(fn: Callable, *args, device: str = "cuda"
              ) -> Tuple[float, object]:
    """One run of fn(*args) in device milliseconds, plus its result. With
    device='cpu', asked for by the caller, the milliseconds of the host's
    clock around the call instead."""
    if device == "cpu":
        t0 = time.perf_counter()
        out = fn(*args)
        return (time.perf_counter() - t0) * 1e3, out
    if not torch.cuda.is_available():
        raise RuntimeError("device timing needs a CUDA device")
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn(*args)
    end.record()
    end.synchronize()
    return start.elapsed_time(end), out


def timed_reps(fn: Callable, *args, reps: int = 3, device: str = "cuda"
               ) -> Tuple[List[float], object]:
    """One untimed warm-up (it builds kernels and fills the allocator's
    cache), then `reps` timed runs (`timed_run` on `device`); returns
    (ms list, last result)."""
    out = fn(*args)
    if device != "cpu":
        torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        ms, out = timed_run(fn, *args, device=device)
        times.append(ms)
    return times, out


def per_call_ms(fn: Callable, *args, calls: int = 10, reps: int = 5) -> float:
    """A kernel's device time: after one warm-up, `calls` calls of
    fn(*args) back to back between two events, so the host's launch work
    overlaps the device's as in a path's loop; the median over `reps` such
    runs of their time divided by `calls`."""
    def run():
        for _ in range(calls - 1):
            fn(*args)
        return fn(*args)

    return statistics.median(timed_reps(run, reps=reps)[0]) / calls
