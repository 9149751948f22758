"""Region-based profiler: semiprof's API, with spans on PyTorch's
profiler and on the card's stream.

PyTorch counterpart of `conflux_tpu/profiler.py`. The reference times each
substep with semiprof's `PE(name)` / `PL()` and prints a sorted region
tree with `PP()` (libs/semiprof/include/semiprof/semiprof.hpp:38-52,
src/conflux/lu/profiler.hpp:5-19); this module keeps that API, the region
tree and the report format.

`span(name)` (and `region(name, sync=)`, a span that may close on a
fence) has two states:

  * off (`enable(False)` and no `torch.profiler` session recording): it
    returns one shared null context after one flag test, and opens no
    profiler range, no NVTX range, no CUDA event and reads no clock;
  * on: it opens a profiler range of the name and, in a process that
    uses the card, an NVTX range, so the span lies on the kernels'
    timeline in a `torch.profiler` trace (and in nsys). The range has an
    op's scope (`_RecordFunctionFast`), not `torch.profiler.
    record_function`'s user scope, for which the profiler also adds a
    device-side annotation event over the span's kernels, which a trace
    would read as device work. Under
    `enable(True)` it also enters the region tree (calls, host wall) and,
    unless a `torch.profiler` session is recording (its trace already
    holds the device side), records a CUDA timing event on the current
    stream at entry and exit: the span's stream time, idle inside it
    included, resolved into the tree (`_Node.device`) when a table is
    read (`snapshot`, `PP`), after one synchronize.

A span never synchronizes. `sync=` is a tensor (the region waits for its
card, `torch.cuda.synchronize(device)`; a CPU tensor needs no fence) or a
callable the region calls before it stops its host clock.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch
import torch.autograd.profiler as _autograd_profiler
from torch._C._profiler import _RecordFunctionFast

# what a span returns when off
_NULL = contextlib.nullcontext()


@dataclass
class _Node:
    calls: int = 0
    wall: float = 0.0
    children: Dict[str, "_Node"] = field(default_factory=dict)
    device: Optional[float] = None    # stream seconds, where recorded


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
        self._pending: List[tuple] = []  # (node, start, end) CUDA events
        self._events: List[torch.cuda.Event] = []  # free for reuse

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

    def region(self, name: str, sync=None):
        """Context-manager form of enter/leave, a span of the module
        docstring: the shared null context when off."""
        if self.enabled or _autograd_profiler._is_profiler_enabled:
            return self._span(name, sync)
        return _NULL

    @contextlib.contextmanager
    def _span(self, name: str, sync):
        card = torch.cuda.is_initialized()
        timed = self.enabled
        start = None
        if timed:
            self.enter(name)
            node = self._stack[-1][1]
            if card and not _autograd_profiler._is_profiler_enabled:
                start = self._event()
        if card:
            torch.cuda.nvtx.range_push(name)
        try:
            with _RecordFunctionFast(name):
                yield
        finally:
            if card:
                torch.cuda.nvtx.range_pop()
            if start is not None:
                self._pending.append((node, start, self._event()))
            if timed:
                self.leave(sync=sync)

    def _event(self) -> torch.cuda.Event:
        """A timing event, from the pool where one is free, recorded on
        the current stream."""
        ev = (self._events.pop() if self._events
              else torch.cuda.Event(enable_timing=True))
        ev.record()
        return ev

    def _drain(self) -> None:
        """After one synchronize, add the pending spans' stream time to
        their nodes and return their events to the pool."""
        if not self._pending:
            return
        torch.cuda.synchronize()
        for node, start, end in self._pending:
            node.device = (node.device or 0.0) + start.elapsed_time(end) / 1e3
            self._events += (start, end)
        self._pending = []

    def clear(self) -> None:
        self.root = _Node()
        self._stack = []
        self._events += [ev for _, s, e in self._pending for ev in (s, e)]
        self._pending = []

    def snapshot(self) -> Dict[str, tuple]:
        """The region tree as {path: (calls, host_s, device_s)}, a path
        being the names from the root joined by '/'; device_s is None
        where no event was recorded."""
        self._drain()
        out = {}

        def walk(node: _Node, prefix: str):
            for name, child in node.children.items():
                path = prefix + name
                out[path] = (child.calls, child.wall, child.device)
                walk(child, path + "/")

        walk(self.root, "")
        return out

    def _table(self, head: str, value) -> str:
        total = sum(value(c) or 0.0
                    for c in self.root.children.values()) or 1e-30
        lines = [f"{'REGION':<40}{'CALLS':>10}{head:>12}{'%':>8}"]

        def walk(node: _Node, depth: int):
            items = sorted(node.children.items(),
                           key=lambda kv: value(kv[1]) or 0.0, reverse=True)
            for name, child in items:
                t = value(child)
                cols = (f"{'-':>12}{'':>8}" if t is None else
                        f"{t:>12.6f}{100 * t / total:>8.1f}")
                lines.append(f"{'  ' * depth + name:<40}{child.calls:>10}"
                             + cols)
                walk(child, depth + 1)

        walk(self.root, 0)
        return "\n".join(lines)

    def report(self) -> str:
        """The sorted region tree in semiprof's `PP()` format (REGION /
        CALLS / WALL / % columns, README.md:119-167)."""
        return self._table("WALL(s)", lambda n: n.wall)

    def device_report(self) -> Optional[str]:
        """The same tree with each span's stream time (DEVICE(s)) in place
        of its host wall, or None where no span recorded events."""
        if not any(v[2] is not None for v in self.snapshot().values()):
            return None
        return self._table("DEVICE(s)", lambda n: n.device)


_GLOBAL = Profiler(enabled=False)


def enable(on: bool = True) -> None:
    _GLOBAL.enabled = on


def PE(name: str) -> None:  # noqa: N802  (macro-name parity)
    _GLOBAL.enter(name)


def PL(sync=None) -> None:  # noqa: N802
    _GLOBAL.leave(sync=sync)


def PP() -> None:  # noqa: N802
    """Print the region tree and, where spans recorded events, the same
    tree in stream time."""
    print(_GLOBAL.report())
    device = _GLOBAL.device_report()
    if device is not None:
        print(device)


def PC() -> None:  # noqa: N802
    _GLOBAL.clear()


def snapshot() -> Dict[str, tuple]:
    return _GLOBAL.snapshot()


def region(name: str, sync=None):
    return _GLOBAL.region(name, sync=sync)


def span(name: str):
    """A phase span of the step loops (module docstring): the shared
    null context when off; never a fence."""
    if _GLOBAL.enabled or _autograd_profiler._is_profiler_enabled:
        return _GLOBAL._span(name, None)
    return _NULL
