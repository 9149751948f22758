"""Region-based wall-clock profiler: semiprof's API, with hooks into
PyTorch's profiler.

PyTorch counterpart of `conflux_tpu/profiler.py`. The reference times each
substep with semiprof's `PE(name)` / `PL()` and prints a sorted region
tree with `PP()` (libs/semiprof/include/semiprof/semiprof.hpp:38-52,
src/conflux/lu/profiler.hpp:5-19); this module keeps that API, the region
tree and the report format. A `region` also opens
`torch.profiler.record_function` and, where a card is present, an NVTX
range, so its name shows in device traces (`device_trace`).

CUDA work is asynchronous: a region that launches kernels times only
their launch unless it closes with a fence. `sync=` is a tensor (the
region waits for its card, `torch.cuda.synchronize(device)`; a CPU
tensor needs no fence) or a callable the region calls before it stops
its clock.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field
from typing import Dict, List

import torch


@dataclass
class _Node:
    calls: int = 0
    wall: float = 0.0
    children: Dict[str, "_Node"] = field(default_factory=dict)


def _fence(sync) -> None:
    if sync is None:
        return
    if isinstance(sync, torch.Tensor):
        if sync.is_cuda:
            torch.cuda.synchronize(sync.device)
        return
    sync()


class Profiler:
    """Nested region profiler; one per process, not thread-safe."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.root = _Node()
        self._stack: List[tuple] = []  # (name, node, t0)

    # -- semiprof-style API (PE/PL/PP/PC) ------------------------------------

    def enter(self, name: str) -> None:
        if not self.enabled:
            return
        parent = self._stack[-1][1] if self._stack else self.root
        node = parent.children.setdefault(name, _Node())
        self._stack.append((name, node, time.perf_counter()))

    def leave(self, sync=None) -> None:
        if not self.enabled or not self._stack:
            return
        _fence(sync)
        name, node, t0 = self._stack.pop()
        node.calls += 1
        node.wall += time.perf_counter() - t0

    @contextlib.contextmanager
    def region(self, name: str, sync=None):
        """Context-manager form of enter/leave; also a `record_function`
        range and, with a card, an NVTX range of the same name."""
        nvtx = torch.cuda.is_available()
        self.enter(name)
        if nvtx:
            torch.cuda.nvtx.range_push(name)
        try:
            with torch.profiler.record_function(name):
                yield
        finally:
            if nvtx:
                torch.cuda.nvtx.range_pop()
            self.leave(sync=sync)

    def clear(self) -> None:
        self.root = _Node()
        self._stack = []

    def report(self) -> str:
        """The sorted region tree in semiprof's `PP()` format (REGION /
        CALLS / WALL / % columns, README.md:119-167)."""
        total = sum(c.wall for c in self.root.children.values()) or 1e-30
        lines = [f"{'REGION':<40}{'CALLS':>10}{'WALL(s)':>12}{'%':>8}"]

        def walk(node: _Node, depth: int):
            items = sorted(node.children.items(), key=lambda kv: kv[1].wall,
                           reverse=True)
            for name, child in items:
                lines.append(
                    f"{'  ' * depth + name:<40}{child.calls:>10}"
                    f"{child.wall:>12.6f}{100 * child.wall / total:>8.1f}")
                walk(child, depth + 1)

        walk(self.root, 0)
        return "\n".join(lines)


_GLOBAL = Profiler(enabled=False)


def no_region(name: str):
    """A region that times and marks nothing: the rank programs' default
    substep hook."""
    return contextlib.nullcontext()


def enable(on: bool = True) -> None:
    _GLOBAL.enabled = on


def PE(name: str) -> None:  # noqa: N802  (macro-name parity)
    _GLOBAL.enter(name)


def PL(sync=None) -> None:  # noqa: N802
    _GLOBAL.leave(sync=sync)


def PP() -> None:  # noqa: N802
    print(_GLOBAL.report())


def PC() -> None:  # noqa: N802
    _GLOBAL.clear()


def region(name: str, sync=None):
    return _GLOBAL.region(name, sync=sync)


@contextlib.contextmanager
def device_trace(logdir: str):
    """Trace the block with `torch.profiler` (CPU and, with a card, CUDA
    activities) and write its Chrome trace to `logdir`/trace_rank<r>.json
    (r the process's rank, 0 without a process group); yields the
    profiler, whose `key_averages()` sum the kernels. Replaces
    `jax.profiler.trace`."""
    import torch.distributed as dist

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    rank = dist.get_rank() if dist.is_initialized() else 0
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, f"trace_rank{rank}.json"))
