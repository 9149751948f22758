"""The readings that a cell's limits are set from, on the card at the
cell's own size, in one process:

    python3 -m benchmark.calibrate --workload <cell> --seeds 1-12 \
        --control-seeds 101-103 [--plain-seeds 201-203] [--out FILE]

For each seed of --seeds, the program (the configuration's entry point,
as the window calls it) on input 0 of a run with that seed; for each of
--control-seeds the driver's controls, one precision below the
configuration's: the reference in the program's place with its products
on TF32 operands, and the program's own 'bf16' products; for each of
--plain-seeds the reference in IEEE fp32 (a second witness) and two
planted faults: the input returned as its own factor (a state left
unchanged) and one answer altered where it is produced (one entry of the
program's factor below the diagonal negated). Every reading is the
reference's (`benchmark.reference`), one JSON line each. The benchmark's
own runs never run this.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time


def _seeds(text: str):
    out = []
    for part in text.split(","):
        if "-" in part:
            a, b = part.split("-")
            out += list(range(int(a), int(b) + 1))
        elif part:
            out.append(int(part))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--plain-seeds", default="")
    ap.add_argument("--out")
    args = ap.parse_args(argv)

    import torch

    from benchmark import spec

    if not torch.cuda.is_available():
        sys.exit("benchmark.calibrate: needs a CUDA card")
    cell = spec.load_cell(args.workload)
    drv, cfg, n = cell.driver, cell.config, cell.traffic["n"]
    # the program on one card; a multi-card cell's program readings are
    # its runs' own
    factor = drv.prepare(cfg, n, "cuda") if args.seeds else None

    def altered(A):
        out = factor(A)
        F = out[0] if isinstance(out, tuple) else out
        F[n // 2, n // 3] *= -1
        return out

    def unchanged(A):
        if cfg["judge"] == "lu":
            return A.clone(), torch.arange(n, device=A.device)
        return A.clone()

    sides = [("program", s, factor) for s in _seeds(args.seeds)]
    for s in _seeds(args.control_seeds):
        sides += [(name, s, fn) for name, fn in drv.controls(cfg).items()]
    for s in _seeds(args.plain_seeds):
        sides += [("plain", s, lambda A: drv.plain(cfg, A)),
                  ("fault_unchanged", s, unchanged)]
        if factor is not None:
            sides.append(("fault_altered", s, altered))
    with (open(args.out, "a") if args.out
          else contextlib.nullcontext()) as sink:
        for side, seed, fn in sides:
            _read(args.workload, drv, cfg, n, side, seed, fn, sink)


def _read(cell: str, drv, cfg: dict, n: int, side: str, seed: int, fn,
          sink):
    """One reading: fn on input 0 of `seed`, judged; printed and
    appended to sink."""
    import torch

    A = drv.judge_input(cfg, n, seed, 0, "cuda")
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn(A)
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t
    t = time.perf_counter()
    got = drv.readings(cfg, A, out)
    t_judge = time.perf_counter() - t
    del A, out
    torch.cuda.empty_cache()
    row = json.dumps({"cell": cell, "side": side, "seed": seed,
                      "run_s": t_run, "judge_s": t_judge, **got})
    print(row, flush=True)
    if sink:
        sink.write(row + "\n")
        sink.flush()


if __name__ == "__main__":
    main()
