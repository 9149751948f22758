"""The traced part of a `--trace 1` run: a few factorizations under
`torch.profiler`, reduced to device time per kernel group, launches, the
device's busy time, and the host's work during the device's idle gaps.

Only `DeviceType.CUDA` events count as device time (the `aten::` rows
repeat their kernels' time). Groups are the frozen table in
`kernel_groups.json`.
"""

from __future__ import annotations

import json
import time
from collections import defaultdict
from pathlib import Path

GROUPS = tuple((label, tuple(keys)) for label, keys in json.loads(
    (Path(__file__).with_name("kernel_groups.json")).read_text())["groups"])
TOP = 10


def group(name: str) -> str:
    for label, keys in GROUPS:
        if any(k in name for k in keys):
            return label
    return "other"


def per_factor_ms(t: dict, groups) -> float | None:
    """Device ms per traced factorization of the kernel groups `groups`
    in the summary t, or None where the trace has none of them."""
    ms = sum(t["groups"][g]["ms"] for g in groups if g in t["groups"])
    return ms / t["count"] if ms > 0 else None


def _merge(intervals):
    """Sorted, overlapping intervals merged."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _innermost(host, points):
    """For each point (sorted), the name of the innermost host event of
    `host` ([(start, end, name)], properly nested) that contains it, or
    None."""
    host = sorted(host, key=lambda h: (h[0], -h[1]))
    parent, stack = [], []
    for i, (s, e, _) in enumerate(host):
        while stack and host[stack[-1]][1] < e:
            stack.pop()
        parent.append(stack[-1] if stack else -1)
        stack.append(i)
    names, i = [], -1
    for p in points:
        while i + 1 < len(host) and host[i + 1][0] <= p:
            i += 1
        j = i
        while j >= 0 and host[j][1] < p:
            j = parent[j]
        names.append(host[j][2] if j >= 0 else None)
    return names


def summarize(events, count: int, window_s: float) -> dict:
    """The trace of `count` factorizations over `window_s` seconds of host
    clock, from the profiler's events: per group its device ms and
    launches, the kernel launches, the device-busy seconds (the union of
    the device events), and the idle gaps between device events summed by
    the innermost host event open at each gap's middle."""
    from torch.profiler import DeviceType

    groups = defaultdict(lambda: [0.0, 0])
    dev, host = [], []
    kernels = 0
    for ev in events:
        s, e = ev.time_range.start, ev.time_range.end
        if ev.device_type == DeviceType.CUDA:
            g = groups[group(ev.name)]
            g[0] += (e - s) / 1e3
            g[1] += 1
            dev.append((s, e))
            if not ev.name.startswith(("Memcpy", "Memset")):
                kernels += 1
        elif not ev.is_async and e > s:
            host.append((s, e, ev.name))
    busy = _merge(dev)
    gaps = [(a[1], b[0]) for a, b in zip(busy, busy[1:]) if b[0] > a[1]]
    idle = defaultdict(float)
    for (s, e), name in zip(gaps, _innermost(
            host, [(s + e) / 2 for s, e in gaps])):
        idle[name or "host Python, no op open"] += (e - s) / 1e6
    return {
        "count": count,
        "window_s": window_s,
        "busy_s": sum(e - s for s, e in busy) / 1e6,
        "kernels": kernels,
        "groups": {k: {"ms": v[0], "launches": v[1]}
                   for k, v in groups.items()},
        "device_ops": sorted(([k, v[0] / 1e3] for k, v in groups.items()),
                             key=lambda kv: -kv[1])[:TOP],
        "idle_gaps": sorted(([k, v] for k, v in idle.items()),
                            key=lambda kv: -kv[1])[:TOP],
    }


def profile(run_one, count: int) -> dict:
    """Run run_one(i) for i < count (each ending in a synchronize) under
    the profiler and summarize the trace."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(count):
            run_one(i)
        window_s = time.perf_counter() - t0
    return summarize(prof.events(), count, window_s)
