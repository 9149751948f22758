#!/usr/bin/env python3
"""Time the PyTorch port's three LU schemes on one card, and name the
threshold of `lu.single.auto_scheme` that the timings give.

    python3 -m experiments.torch_schemes

For each configuration of SWEEP (N, v, precision), on bench.py's input
A = 5 + U(0, 1) made on the card from seed 42: one warm-up
`lu_factor(A, v, precision, scheme=s)` of each scheme s (recursive, flat,
crout), gated by `lu_residual_blocked` <= 1e-6, then ROUNDS rounds, each
timing every scheme once (CUDA events around the call, `timing.timed_run`)
in an order that rotates from round to round, so that the schemes share
the call's drift. Prints, per (N, v, precision, scheme), the median wall
and its min-max, the peak device memory of the timed runs
(`torch.cuda.max_memory_allocated`, A included) in GiB and in copies of
A, and the residual; one JSON line per row goes to OUT.

Then the threshold by the rule of DECIDING's rows: a scheme wins at an N
when its median is lower than the other's by more than half of the larger
min-max range of the two; where neither wins, the JAX package's choice
at that N stands (recursive below 16384). T is the smallest swept N from
which crout is the choice at every larger swept N. If recursive is the
choice at the largest N, recursive and crout are timed at BIG_N too; if it
is still the choice there, T is the smallest N at which recursive's
measured peak at that size, scaled by N squared, passes MEM_SHARE of the
card's memory. Prints the rule's T for every configuration, so that the
other configurations' answers can be compared. Exits non-zero if a
residual fails or no card is present. Imports no jax.
"""

import json
import math
import os
import statistics
import subprocess
import sys

import torch

from conflux_tpu_torch.lu.single import lu_factor
from conflux_tpu_torch.timing import timed_run
from conflux_tpu_torch.validation import lu_residual_blocked

SCHEMES = ("recursive", "flat", "crout")
SIZES = (2048, 4096, 8192, 16384, 32768)
# (v, precision, sizes): bench.py's configuration (which decides), the one
# the JAX threshold was measured at, and lu_factor's defaults (cut at 8192:
# v = 128 at N = 32768 is ~256 host-bound steps a run)
DECIDING = (1536, "high")
SWEEP = ((1536, "high", SIZES), (1024, "high", SIZES),
         (128, "highest", SIZES[:3]))
BIG_N = 49152
ROUNDS = 5
GATE = 1e-6
# the JAX package's threshold, kept where the card cannot tell the two apart
JAX_CROUT_FROM = 16384
MEM_SHARE = 0.8
OUT = "chiprun_out/torch_schemes.jsonl"


def _input(n: int) -> torch.Tensor:
    g = torch.Generator(device="cuda").manual_seed(42)
    return 5.0 + torch.rand(n, n, generator=g, device="cuda")


def time_schemes(n: int, v: int, precision: str, schemes=SCHEMES):
    """One row per scheme at (n, v, precision): its walls over ROUNDS
    interleaved rounds after one warm-up, its peak device memory over the
    timed runs and the warm-up's residual."""
    A = _input(n)
    rows = {}
    for s in schemes:
        F, perm = lu_factor(A, v, precision, scheme=s)
        res = lu_residual_blocked(A, F, perm)
        del F, perm
        rows[s] = {"N": n, "v": v, "precision": precision, "scheme": s,
                   "walls_ms": [], "peak_bytes": 0, "residual": res}
    for r in range(ROUNDS):
        order = schemes[r % len(schemes):] + schemes[:r % len(schemes)]
        for s in order:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            # the result is dropped at once: the next run's peak holds
            # A and its own work only
            ms = timed_run(lambda: lu_factor(A, v, precision,
                                             scheme=s))[0]
            row = rows[s]
            row["walls_ms"].append(ms)
            row["peak_bytes"] = max(row["peak_bytes"],
                                    torch.cuda.max_memory_allocated())
    for row in rows.values():
        w = row["walls_ms"]
        row.update(median_ms=statistics.median(w), min_ms=min(w),
                   max_ms=max(w), peak_gib=row["peak_bytes"] / 2 ** 30,
                   peak_copies=row["peak_bytes"] / A.nbytes)
    return list(rows.values())


def winner(rec: dict, crt: dict):
    """'recursive', 'crout' or None: the scheme whose median is lower by
    more than half of the larger min-max range of the two."""
    margin = 0.5 * max(rec["max_ms"] - rec["min_ms"],
                       crt["max_ms"] - crt["min_ms"])
    if rec["median_ms"] < crt["median_ms"] - margin:
        return "recursive"
    if crt["median_ms"] < rec["median_ms"] - margin:
        return "crout"
    return None


def choice(rec: dict, crt: dict) -> str:
    """The winner, or the JAX package's choice at that N."""
    return winner(rec, crt) or ("recursive" if rec["N"] < JAX_CROUT_FROM
                                else "crout")


def picks(rows):
    """(sizes, the choice at each, rows by size and scheme) of one
    configuration's rows; a size where recursive ran out of memory picks
    crout."""
    by_n = {}
    for r in rows:
        by_n.setdefault(r["N"], {})[r["scheme"]] = r
    ns = sorted(n for n in by_n if {"recursive", "crout"} <= set(by_n[n]))
    return ns, ["crout" if by_n[n]["recursive"].get("oom") else
                choice(by_n[n]["recursive"], by_n[n]["crout"])
                for n in ns], by_n


def threshold(rows, card_bytes: int):
    """(T, how) by the module docstring's rule over one configuration's
    rows."""
    ns, picks_, by_n = picks(rows)
    if picks_[-1] == "recursive":
        peak = by_n[ns[-1]]["recursive"]["peak_bytes"]
        t = math.ceil(ns[-1] * math.sqrt(MEM_SHARE * card_bytes / peak))
        return t, (f"recursive is the choice at every swept N up to "
                   f"{ns[-1]}: T where its peak ({peak / 2 ** 30:.3f} GiB "
                   f"at N={ns[-1]}) scaled by N^2 passes {MEM_SHARE} of "
                   f"the card's {card_bytes / 2 ** 30:.1f} GiB")
    i = len(picks_)
    while i > 0 and picks_[i - 1] == "crout":
        i -= 1

    def why(n):
        rec, crt = by_n[n]["recursive"], by_n[n]["crout"]
        if rec.get("oom"):
            return " (recursive out of memory)"
        return "" if winner(rec, crt) else " (no winner: the JAX choice)"

    return ns[i], "choices by N: " + ", ".join(
        f"{n} {p}{why(n)}" for n, p in zip(ns, picks_))


def _print(row, smi):
    if row.get("oom"):
        print(f"N={row['N']} v={row['v']} '{row['precision']}' "
              f"{row['scheme']:9s} out of device memory on {smi}")
        return
    print(f"N={row['N']} v={row['v']} '{row['precision']}' "
          f"{row['scheme']:9s} median {row['median_ms']:.3f} ms "
          f"(min-max {row['min_ms']:.3f}-{row['max_ms']:.3f}), peak "
          f"{row['peak_gib']:.3f} GiB = {row['peak_copies']:.3f} copies "
          f"of A, lu_residual_blocked {row['residual']:.3e} on {smi}",
          flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_schemes: needs a CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    card_bytes = torch.cuda.get_device_properties(0).total_memory
    print(f"torch_schemes on {smi}, torch {torch.__version__}, "
          f"{card_bytes / 2 ** 30:.1f} GiB", flush=True)
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    every = {}
    with open(OUT, "w") as out:
        def record(rows):
            for row in rows:
                _print(row, smi)
                out.write(json.dumps({**row, "card": smi}) + "\n")
                out.flush()

        for v, precision, sizes in SWEEP:
            rows = []
            for n in sizes:
                rows += time_schemes(n, v, precision)
                record(rows[-len(SCHEMES):])
            if (v, precision) == DECIDING and picks(rows)[1][-1] == \
                    "recursive":
                try:
                    big = time_schemes(BIG_N, v, precision,
                                       ("recursive", "crout"))
                except torch.OutOfMemoryError as e:
                    # a finding to record: crout alone is timed there
                    print(f"N={BIG_N}: recursive and crout together ran "
                          f"out of device memory: {e}", flush=True)
                    torch.cuda.empty_cache()
                    big = time_schemes(BIG_N, v, precision, ("crout",))
                    big.append({"N": BIG_N, "v": v, "precision": precision,
                                "scheme": "recursive", "oom": True})
                record(big)
                rows += big
            every[(v, precision)] = rows
    bad = [r for rows in every.values() for r in rows
           if not r.get("oom") and not r["residual"] <= GATE]
    for (v, precision), rows in every.items():
        t, how = threshold(rows, card_bytes)
        tag = "DECIDES" if (v, precision) == DECIDING else "compare"
        print(f"threshold v={v} '{precision}' ({tag}): T = {t}; {how}")
    if bad:
        print(f"torch_schemes: residual over {GATE}: {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
