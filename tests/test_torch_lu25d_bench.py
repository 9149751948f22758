"""The 2.5D LU as the benchmark runs it (cell lu25d.n16384.p4): the program
against the plain CALU, the benchmark's driver, and the spans and counters
its per-layer metrics read. On the CPU, in one gloo world of four ranks
on (2, 2, 1) (tests/torch_ranks.py:lu25d_cases), and the driver in fresh
interpreters (tests/torch_lu25d_driver.py).

Parity. At 'highest' with no row rebalance (rowpart 0, the plain's
'fori' row layout) the program's tournament must pick the plain CALU's
pivots exactly (benchmark/drivers/lu25d_plain.py). F is held to the
plain's F at 2 N eps of max|F|: both are fp32 factors, each 1e-5 to
1e-4 of max|F| from the float64 CALU with the same pivots at N = 256-512
(the program's TRSMs multiply by inverted triangles), so the 2e-5 of the
parity tests at N <= 72 does not hold here; each also meets the
reference's backward error gate, 1e-6.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_ranks
from benchmark.drivers import lu25d
from benchmark.drivers import lu25d_plain as plain_calu
from conflux_tpu_torch.launch import run_ranks

ROOT = Path(__file__).resolve().parents[1]
GATE = 1e-6
EPS = float(np.finfo(np.float32).eps)
# (N, v, unroll, rowpart): 'windowed' without its rebalance, and the
# variant lu_25d picks itself below N = 8192 ('fori')
PARITY = ((256, 32, "windowed", 0), (512, 64, None, None))
WORK = (512, 128)        # K3 needs an update rank that is a multiple of 128
SPANS = (256, 32)


def _normal(seed, n):
    return torch.randn(n, n, generator=torch.Generator().manual_seed(seed))


def _fill(seed, n):
    """CONFLUX's benchmark fill, 5 + U[0, 1)."""
    return torch.rand(n, n, generator=torch.Generator().manual_seed(seed)) + 5


def _cfg():
    return {"parity": [(_normal(10 + i, n), v, unroll, rowpart)
                       for i, (n, v, unroll, rowpart) in enumerate(PARITY)],
            "work": (_fill(20, WORK[0]), WORK[1]),
            "spans": (_fill(21, SPANS[0]), SPANS[1])}


@pytest.fixture(scope="module")
def world():
    return run_ranks(4, torch_ranks.lu25d_cases, _cfg(), device="cpu",
                     timeout=300)


def _resid(A, F, perm):
    A, F = A.double(), torch.as_tensor(F).double()
    n = A.shape[0]
    L = torch.tril(F, -1) + torch.eye(n, dtype=F.dtype)
    D = A[torch.as_tensor(perm)] - L @ torch.triu(F)
    return float(torch.linalg.norm(D) / (n * torch.linalg.norm(A)))


def test_every_rank_is_jax_free(world):
    assert all(r["jax_free"] for r in world)


@pytest.mark.parametrize("i", range(len(PARITY)),
                         ids=[f"n{n}-v{v}-{u}" for n, v, u, _ in PARITY])
def test_program_picks_the_plain_calus_pivots(world, i):
    A, v, _, _ = _cfg()["parity"][i]
    n = A.shape[0]
    F, piv = world[0]["parity"][i]
    for r in world[1:]:
        assert np.array_equal(r["parity"][i][1], piv)
    Fp, pp = plain_calu.calu(A, v, 2)
    assert np.array_equal(piv, pp.numpy())
    err = np.abs(F - Fp.numpy()).max() / np.abs(F).max()
    assert err <= 2 * n * EPS, err
    assert _resid(A, F, piv) <= GATE
    assert _resid(A, Fp, pp) <= GATE


def test_plain_calu_tf32_products_are_a_precision_lower():
    A = _fill(3, 256)
    F, p = plain_calu.calu(A, 32, 2)
    Ft, pt = plain_calu.calu(A, 32, 2, tf32=True)
    assert _resid(A, F, p) < 1e-8
    assert _resid(A, Ft, pt) > 30 * _resid(A, F, p)


def test_the_drivers_work_is_the_programs_launches(world):
    """Rank 0's K1 blocks and K3 updates of a 'windowed' 'high'
    factorization, as the program launched them, are the driver's
    count, which its rooflines read."""
    n, v = WORK
    got = world[0]["work"]
    assert got["k3"] == lu25d.k3_updates(n, v, 2, 2, 1, "high")
    assert Counter(got["k1"]) == Counter(lu25d.k1_blocks(n, v, 2, 2))
    assert got["k1"] == lu25d.k1_blocks(n, v, 2, 2)
    # the row rebalance shrank the working rows, so the count follows it
    assert len({m for m, _, _ in got["k3"]}) > 1
    config = json.loads((ROOT / "benchmark" / "configs"
                         / "lu25d-tournament-p4.json").read_text())
    work = lu25d.work_of(config, 16384)
    assert work["launches"] == {"rank1_panel": 768, "schur_update": 32}
    # no K2 product runs: its least time is a counted zero, not unknown
    assert work["k2_least_ms"] == 0.0
    # three bf16 passes of about a quarter of 2/3 N^3 at 989 TFLOP/s
    assert 1.5 < work["k3_least_ms"] < 3.5


def test_spans_and_records_of_the_rank_program(world):
    """Under a torch.profiler session the rank program's entry and
    substep spans and one comm.<op> span per collective appear; enabled,
    they fill the span table under lu25d.factor; off, on and traced
    factors are bit-identical."""
    n, v = SPANS
    steps = n // v
    for r in world:
        got = r["spans"]
        assert got["identical"]
        ops = Counter(f"comm.{rec.op}" for rec in got["records"])
        want = {"lu25d.factor": 1, **{f"lu25d.{s}": steps for s in (
            "step0_reduce", "step1_pivot", "step23_rows", "step45_trsm",
            "step6_update")}, **ops}
        assert got["events"] == want
        table = got["table"]
        assert table["lu25d.factor"] == 1
        assert table["lu25d.factor/lu25d.step1_pivot"] == steps
        assert sum(c for path, c in table.items()
                   if path.split("/")[-1].startswith("comm.")) == sum(
                       ops.values())


def test_comm_records_carry_each_operands_bytes(world):
    for r in world:
        recs = r["spans"]["records"]
        assert recs
        for rec in recs:
            size = torch.empty((), dtype=getattr(torch, rec.dtype))
            assert rec.nbytes == math.prod(rec.shape) * size.element_size()


def _driver(case: str, timeout: float = 240):
    return subprocess.run([sys.executable, str(ROOT / "tests" /
                                               "torch_lu25d_driver.py"),
                           case], cwd=ROOT, capture_output=True, text=True,
                          timeout=timeout)


def _gone(pids, within: float = 10.0) -> bool:
    deadline = time.monotonic() + within
    while time.monotonic() < deadline:
        alive = []
        for pid in pids:
            try:
                os.kill(pid, 0)
                alive.append(pid)
            except ProcessLookupError:
                pass
        if not alive:
            return True
        time.sleep(0.2)
    return False


def test_the_driver_through_the_harness():
    """The cell at N = 256 on four gloo ranks through run_cell: correct;
    both planted faults fail in the same world; rank 0 sends one message
    a factorization and runs one all-reduce of its own; every worker
    leaves with code 0; nothing loads JAX."""
    done = _driver("run")
    assert done.returncode == 0, done.stderr[-3000:]
    got = json.loads(done.stdout.strip().splitlines()[-1])
    assert got["correct"] is True
    assert got["unchanged"]["correct"] is False
    assert got["altered"]["correct"] is False
    assert got["unchanged"]["failed"] >= 1 and got["altered"]["failed"] >= 1
    assert got["same_world"]
    # the sound run: two inputs, each factored once at set-up and once in
    # its window, one message and one all-reduce a factorization, and no
    # input moved after it was made
    assert got["sent"]["factor"] == 4
    assert got["sent"]["input"] == 2
    assert "scatter" not in got["sent"]
    assert got["collectives"] == {"all_reduce": 4}
    assert got["codes"] == [0, 0, 0]
    assert _gone(got["pids"])
    assert got["forbidden"] == []


@pytest.mark.parametrize("case", ["dead", "stall"])
def test_a_dead_or_stalled_rank_ends_the_run(case):
    t = time.monotonic()
    done = _driver(case)
    assert done.returncode == 3, (done.returncode, done.stderr[-3000:])
    assert time.monotonic() - t < 120
    assert "survived" not in done.stdout
    assert "ending the run" in done.stderr
    pids = json.loads(done.stdout.strip().splitlines()[0])["pids"]
    assert _gone(pids)


def test_the_cells_trace_readers():
    """The new readers on a traced run's summary: idle under the rank
    program's spans and under the collectives' host work (the comm.*
    spans and c10d's events inside them) from the top idle gaps, nothing
    where a full list names none; NCCL's kernels are half the group's
    events (each has the profiler's `nccl:<op>` annotation beside it)."""
    from benchmark import spec, trace

    def read(name, **t):
        summary = {"trace": dict({"count": 2, "idle_gaps": [],
                                  "groups": {}}, **t), "work": {}}
        return spec.metric_reader(name, spec.BENCH_DIR).compute(summary)

    gaps = [["lu25d.step1_pivot", 0.4], ["aten::mm", 0.3],
            ["record_param_comms", 0.2], ["comm.ppermute", 0.1],
            ["lu25d.step45_trsm", 0.06]]
    assert read("rank_py_idle_ms", idle_gaps=gaps) == pytest.approx(230.0)
    assert read("comm_idle_ms", idle_gaps=gaps) == pytest.approx(150.0)
    full = [[f"aten::op{i}", 0.01] for i in range(trace.TOP)]
    assert read("rank_py_idle_ms", idle_gaps=full) is None
    assert read("comm_idle_ms", idle_gaps=full) is None
    groups = {"NCCL collectives": {"ms": 40.0, "launches": 884}}
    assert read("nccl_launches_per_factor", groups=groups) == 221.0
    assert read("nccl_ms", groups=groups) == pytest.approx(10.0)
    assert read("nccl_ms") is None


def test_every_metric_of_the_cell_reads_its_traced_run():
    """Every per-layer metric that lists the cell gives a number on a
    traced run's summary of the groups the 'windowed' program launches
    (no K2 among them): a metric left out of a `--trace 1` line refuses
    the cell. K2's roofline reads 0 % there, over the split pass its group
    shares with K3."""
    from benchmark import run, spec

    cell = spec.load_cell("lu25d.n16384.p4")
    groups = {g: {"ms": 20.0, "launches": 100} for g in (
        "NCCL collectives", "split pass of K3 and K2",
        "K3 schur_update_wgmma_kernel", "K1 rank1 grid route",
        "K1 rank1 cluster route", "K1 rank1 tile route",
        "GEMMs (cuBLAS, cutlass)", "copies", "elementwise", "row gathers")}
    trace = {"count": 2, "window_s": 3.0, "busy_s": 0.5, "kernels": 30000,
             "groups": groups, "device_ops": [],
             "idle_gaps": [["lu25d.step1_pivot", 0.5],
                           ["record_param_comms", 0.25]]}
    got = run.per_layer_metrics(cell, run.summary_of(cell, 900.0, 880.0,
                                                     trace))
    assert set(got) == {m["name"] for m, _ in cell.per_layer}
    assert got["k2_roofline.p25d"]["value"] == 0.0
    assert 0 < got["k3_roofline"]["value"] <= 100
