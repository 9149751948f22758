"""The port's benchmark: one run of one cell on the card it starts on.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up makes the cell's inputs on the card from the seed and factors each
once (every shape the window runs; the first run in a checkout also
builds the program's kernels there). The window then calls the
configuration's entry point on the inputs in turn, one caller, a
synchronize after each factorization, until `--seconds` have passed.
After the window the reference judges a sample of the outputs drawn from
the seed, and the last one, on inputs made again from the seed.

The last line of standard output is one JSON object: `correct`,
`attempted`, `failed`, `metrics`, `device`, with `--trace 1` also
`breakdown`, and last `checks`, each number compared with its limit (also
the last lines of standard error). `--trace 0` reports the cell's
end-to-end metrics; `--trace 1` then profiles a few more factorizations
and reports its per-layer metrics. Without a CUDA card, with fewer cards
than the cell asks for, or with JAX or the JAX package loaded, the run
exits non-zero and prints no result.
"""

from __future__ import annotations

import time

_T0 = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import platform  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

# top-level module names that no run may load, compared whole: the port's
# own name begins with the JAX package's
FORBIDDEN = ("jax", "jaxlib", "flax", "conflux_tpu")
# seconds of factorizations that a --trace 1 run profiles after its window
TRACE_S = 1.0


def forbidden_modules(modules=None) -> list:
    """The FORBIDDEN top-level names among the loaded modules."""
    names = {m.split(".")[0] for m in (sys.modules if modules is None
                                       else modules)}
    return sorted(names & set(FORBIDDEN))


def _judge(cell, device, seed: int, n: int, outputs: dict):
    """Each output's readings against the cell's limits: (failed, worst
    reading per number). outputs maps a factorization's index to (its
    input's index, its output) and is emptied as they are judged."""
    drv, cfg = cell.driver, cell.config
    failed, worst = 0, {}
    for i in sorted(outputs):
        j, out = outputs.pop(i)
        A = drv.judge_input(cfg, n, seed, j, device)
        got = drv.readings(cfg, A, out)
        del A, out
        print(f"factorization {i} (input {j}): " + ", ".join(
            f"{k} {v!r}" for k, v in got.items()), file=sys.stderr)
        # a NaN reading fails: it is not within its limit
        if not all(got[k] <= lim["limit"] for k, lim in cell.limits.items()):
            failed += 1
        for k, v in got.items():
            cur = worst.get(k)
            worst[k] = v if cur is None or math.isnan(v) or v > cur else cur
    return failed, worst


def run_cell(cell, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t0: float | None = None,
             factorizations: int = 2) -> dict:
    """One run of `cell`; returns the result line as a dict. On the CPU
    (the tests) the window is `factorizations` calls, nothing is timed
    and no metric is reported."""
    import torch

    from benchmark import trace as tracing
    from benchmark import window

    t0 = _T0 if t0 is None else t0
    drv, cfg, n = cell.driver, cell.config, cell.traffic["n"]
    on_card = device.startswith("cuda")
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    factor = drv.prepare(cfg, n, device)
    inputs = [drv.make_input(cfg, n, seed, j, device)
              for j in range(cell.traffic["inputs"])]
    for A in inputs:
        out = factor(A)
        sync()
        del out
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.monotonic() - t0

    sample = window.Reservoir(cell.traffic["checked"], seed)
    walls, issues = [], []
    last, i = None, 0
    start = time.perf_counter()
    while True:
        last = None                # hold no output but the sample's
        j = i % len(inputs)
        t = time.perf_counter()
        out = factor(inputs[j])
        t_ret = time.perf_counter()
        sync()
        t_end = time.perf_counter()
        walls.append(t_end - t)
        issues.append(t_ret - t)
        sample.offer((i, j, out))
        last = (i, j, out)
        del out
        i += 1
        if (t_end - start >= seconds) if on_card else i >= factorizations:
            break
    elapsed = t_end - start
    peak = torch.cuda.max_memory_allocated() if on_card else None
    ms = sorted(1e3 * w for w in walls)
    print(f"window: {i} factorizations in {elapsed:.3f} s; walls ms "
          f"first {[round(1e3 * w, 1) for w in walls[:3]]}, min "
          f"{ms[0]:.1f}, median {ms[len(ms) // 2]:.1f}, max "
          f"{ms[-1]:.1f}; host issue ms median "
          f"{1e3 * statistics.median(issues):.1f}; set-up "
          f"{setup_s:.3f} s", file=sys.stderr)

    prof = None
    if trace and on_card:
        def one(k):
            factor(inputs[k % len(inputs)])
            sync()
        prof = tracing.profile(one, max(2, math.ceil(TRACE_S * i / elapsed)))
    del inputs, factor
    outputs = {k: (j, out) for k, j, out in sample.items + [last]}
    sample = last = None
    if on_card:
        torch.cuda.empty_cache()
    failed, worst = _judge(cell, device, seed, n, outputs)

    metrics = {}
    if on_card and not trace:
        values = {"factor_ms": window.factor_ms(elapsed, i),
                  "factor_p95_ms": window.p95_ms(walls),
                  "peak_gib": peak / 2 ** 30,
                  "setup_s": setup_s}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    elif on_card:
        metrics = per_layer_metrics(cell, summary_of(
            cell, window.factor_ms(elapsed, i),
            1e3 * statistics.fmean(issues), prof))
    if on_card:
        dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(),
               "count": cell.chips, "memory_peak_bytes": peak}
        watts = _power_limit()
        if watts:
            dev["power_limit"] = watts
    else:
        dev = {"platform": "cpu", "kind": platform.machine(), "count": 1,
               "memory_peak_bytes": None}
    line = {"correct": failed == 0 and len(worst) > 0, "attempted": i,
            "failed": failed, "metrics": metrics, "device": dev}
    if prof is not None:
        dev["busy_s"] = prof["busy_s"]
        dev["window_s"] = prof["window_s"]
        line["breakdown"] = {"device_ops": prof["device_ops"],
                             "idle_gaps": prof["idle_gaps"]}
    line["checks"] = {k: {"value": worst.get(k), "limit": lim["limit"]}
                      for k, lim in cell.limits.items()}
    return line


def summary_of(cell, factor_ms: float, host_issue_ms: float,
               trace: dict) -> dict:
    """What a per-layer metric's `compute` reads: the cell's name, its
    configuration and traffic mix, N, the unprofiled window's
    `factor_ms` and mean `host_issue_ms`, the `trace`
    (benchmark.trace.profile's summary) and `work`, the driver's work of
    one factorization (None where it has none for the configuration)."""
    n = cell.traffic["n"]
    return {"cell": cell.name, "config": cell.config,
            "traffic": cell.traffic, "n": n, "factor_ms": factor_ms,
            "host_issue_ms": host_issue_ms, "trace": trace,
            "work": cell.driver.work_of(cell.config, n)}


def per_layer_metrics(cell, summary: dict) -> dict:
    """Each of the cell's per-layer metrics that its reader finds in the
    summary; a reader that finds nothing returns None and its metric is
    left out."""
    metrics = {}
    for m, reader in cell.per_layer:
        value = reader.compute(summary)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    return metrics


def _power_limit() -> str | None:
    """The card's power limit as nvidia-smi reads it, or None."""
    try:
        done = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader", "-i", "0"],
            capture_output=True, text=True, timeout=30, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    return done.stdout.strip() or None


def emit(line: dict):
    """The checks as the last lines of standard error, then the result as
    the last line of standard output."""
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)


def _fail(msg: str):
    print(f"benchmark.run: {msg}", file=sys.stderr, flush=True)
    sys.exit(2)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        _fail("no CUDA card: the benchmark measures the card and nothing "
              "else")
    from benchmark import spec

    cell = spec.load_cell(args.workload)
    if torch.cuda.device_count() < cell.chips:
        _fail(f"{args.workload} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} present")
    torch.cuda.set_device(0)
    line = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    bad = forbidden_modules()
    if bad:
        _fail(f"the run loaded {bad}: the benchmark measures the PyTorch "
              "port alone")
    emit(line)


if __name__ == "__main__":
    main()
