#!/usr/bin/env python3
"""The step loops' phase spans (`profiler.span`) on a card: their cost
off and on, and the span table of each benchmark cell's call.

    python3 -m experiments.torch_spans [--cells lu.n32768,lu.n16384,...] \
        [--pairs 8] [--seed 2147483659] [--out FILE.json]

Off: the host's time for `with profiler.span(name): pass` in a loop of a
million, less the same loop over the shared null context (what the
span's call adds), and the whole with-statement; both per call. On: the
same with-statement under `profiler.enable(True)`, per span.

Per cell (the benchmark's configuration and N, `benchmark.spec`; its
first input made from `--seed`): one warm call, then `--pairs` pairs of
calls in turns (off, on, on, off, ...), each timed on the host clock from
the call to its synchronize, as the benchmark's window times it. An on
call runs under `profiler.enable(True)` with the table cleared before it
and read after it (`profiler.snapshot`, whose one synchronize falls after
the wall is taken): the entry span's host and stream seconds against the
wall, and the phases' sums against the entry span's. The last on call's
table is printed as `profiler.PP` prints it. Prints the card's name and
power limit; with `--out`, writes every number there. Imports no jax.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import time

import torch

from benchmark import spec
from conflux_tpu_torch import profiler

LOOP = 1_000_000
ON_LOOP = 20_000


def _per_call_us(body) -> float:
    t = time.perf_counter()
    body()
    return 1e6 * (time.perf_counter() - t) / LOOP


def off_cost() -> dict:
    span, null = profiler.span, profiler._NULL

    def spans():
        for _ in range(LOOP):
            with span("lu.update"):
                pass

    def nulls():
        for _ in range(LOOP):
            with null:
                pass

    got = {"with_span_us": [], "with_null_us": []}
    for _ in range(3):
        got["with_span_us"].append(_per_call_us(spans))
        got["with_null_us"].append(_per_call_us(nulls))
    with_span = statistics.median(got["with_span_us"])
    with_null = statistics.median(got["with_null_us"])
    return dict(got, span_call_us=with_span - with_null,
                with_statement_us=with_span)


def on_cost() -> dict:
    """Host µs per span under `profiler.enable(True)` with nothing inside
    it (the profiler range, the NVTX range, the tree and two CUDA
    events), over ON_LOOP spans, three times: the first creates the
    events, the others reuse them from the pool."""
    torch.zeros(1, device="cuda")
    got = []
    profiler.enable(True)
    for _ in range(3):
        profiler.PC()
        t = time.perf_counter()
        for _ in range(ON_LOOP):
            with profiler.span("lu.update"):
                pass
        got.append(1e6 * (time.perf_counter() - t) / ON_LOOP)
        profiler.snapshot()
    profiler.enable(False)
    profiler.PC()
    return {"span_on_us": got, "span_on_pooled_us": statistics.median(
        got[1:])}


def _call(factor, A):
    t = time.perf_counter()
    out = factor(A)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    del out
    return wall


def measure_cell(name: str, seed: int, pairs: int) -> dict:
    cell = spec.load_cell(name)
    drv, cfg, n = cell.driver, cell.config, cell.traffic["n"]
    factor = drv.prepare(cfg, n, "cuda")
    A = drv.make_input(cfg, n, seed, 0, "cuda")
    _call(factor, A)
    family = "chol" if cfg["judge"] == "cholesky" else "lu"
    entry = f"{family}.factor"
    walls = {"off": [], "on": []}
    tables = []
    for i in range(pairs):
        for state in (("off", "on") if i % 2 == 0 else ("on", "off")):
            profiler.PC()
            profiler.enable(state == "on")
            walls[state].append(_call(factor, A))
            if state == "on":
                tables.append(profiler.snapshot())
                text = "\n".join(filter(None, (
                    profiler._GLOBAL.report(),
                    profiler._GLOBAL.device_report())))
            profiler.enable(False)
    rows = []
    for wall, table in zip(walls["on"], tables):
        calls, host, dev = table[entry]
        phases = {path: v for path, v in table.items()
                  if path.startswith(entry + "/")}
        rows.append({
            "wall_s": wall, "entry_host_s": host, "entry_device_s": dev,
            "phases_host_share": sum(v[1] for v in phases.values()) / host,
            "phases_device_share": sum(v[2] for v in phases.values()) / dev,
            "entry_device_over_wall": dev / wall,
            "spans": calls + sum(v[0] for v in phases.values())})
    profiler.PC()
    print(f"--- {name}: the last on call's table\n{text}")
    off_ms = 1e3 * statistics.median(walls["off"])
    on_ms = 1e3 * statistics.median(walls["on"])
    return {"cell": name, "n": n, "seed": seed, "walls_s": walls,
            "off_ms": off_ms, "on_ms": on_ms,
            "on_cost_share": on_ms / off_ms - 1.0, "on_calls": rows,
            "tables": tables}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cells", default="lu.n32768,lu.n16384,chol.n32768")
    ap.add_argument("--pairs", type=int, default=8)
    ap.add_argument("--seed", type=int, default=2 ** 31 + 11)
    ap.add_argument("--out", default=None,
                    help="write every number to this JSON file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("torch_spans needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True).stdout.strip()
    print(f"card: {card}; torch {torch.__version__}")
    result = {"card": card, "torch": torch.__version__, "off": off_cost(),
              "on": on_cost(), "cells": []}
    print("off:", json.dumps(result["off"]))
    print("on:", json.dumps(result["on"]))
    for name in args.cells.split(","):
        got = measure_cell(name, args.seed, args.pairs)
        result["cells"].append(got)
        summary = {k: got[k] for k in ("cell", "off_ms", "on_ms",
                                       "on_cost_share")}
        keys = ("phases_host_share", "phases_device_share",
                "entry_device_over_wall", "spans")
        summary.update({k: [round(r[k], 4) for r in got["on_calls"]]
                        for k in keys})
        print(json.dumps(summary))
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()
