"""The benchmark's 2.5D LU driver (benchmark/drivers/lu25d.py) run on the
CPU in a fresh interpreter, for tests/test_torch_lu25d_bench.py:

    python tests/torch_lu25d_driver.py run|dead|stall

run: the cell at N = 256 through `benchmark.run.run_cell` on four gloo
ranks, then with each of the harness's planted faults; prints one JSON
line with each run's `correct`, the driver's messages and collectives,
and the workers' pids and exit codes after the world is closed. dead /
stall: a worker killed / stopped before a factorization; the watchdog
must end this process non-zero (the pids are printed first).
"""

from __future__ import annotations

import json
import os
import signal
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from benchmark import run, spec  # noqa: E402
from benchmark.drivers import lu25d_ranks  # noqa: E402

CELL = "lu25d.n16384.p4"
N = 256
SEED = 2 ** 31 + 99


def _cell():
    cell = spec.load_cell(CELL)
    cell.traffic = dict(cell.traffic, n=N)
    return cell


def case_run():
    from benchmark.tests.test_bench_harness import _faulty

    out = {}
    line = run.run_cell(_cell(), SEED, 1.0, False, device="cpu",
                        t0=time.monotonic(), factorizations=2)
    world = lu25d_ranks._WORLD
    out["correct"] = line["correct"]
    out["checks"] = line["checks"]
    out["sent"] = dict(world.sent)
    out["collectives"] = dict(world.rank.collectives)
    for fault in ("unchanged", "altered"):
        line = run.run_cell(_faulty(_cell(), fault), SEED, 1.0, False,
                            device="cpu", t0=time.monotonic(),
                            factorizations=2)
        out[fault] = {"correct": line["correct"], "failed": line["failed"]}
    out["same_world"] = lu25d_ranks._WORLD is world
    out["pids"] = [p.pid for p in world.procs]
    out["codes"] = lu25d_ranks.shutdown()
    out["forbidden"] = run.forbidden_modules()
    print(json.dumps(out), flush=True)


def case_fail(how: str):
    cell = _cell()
    factor = cell.driver.prepare(cell.config, N, "cpu")
    A = cell.driver.make_input(cell.config, N, SEED, 0, "cpu")
    factor(A)
    world = lu25d_ranks._WORLD
    print(json.dumps({"pids": [p.pid for p in world.procs]}), flush=True)
    if how == "stall":
        lu25d_ranks.STALL_S = 2.0
        os.kill(world.procs[0].pid, signal.SIGSTOP)
    else:
        os.kill(world.procs[1].pid, signal.SIGKILL)
    factor(A)
    time.sleep(60)
    print(json.dumps({"survived": True}), flush=True)


if __name__ == "__main__":
    if sys.argv[1] == "run":
        case_run()
    else:
        case_fail(sys.argv[1])
