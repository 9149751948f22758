"""CPU tests of the benchmark harness (benchmark/). Tests that need a card
carry the `cuda` marker and look for one inside the test.

    python -m pytest benchmark/tests -q
"""

from __future__ import annotations

import ast
import io
import json
import math
import shutil
import statistics
import subprocess
import sys
import time
from contextlib import redirect_stdout
from pathlib import Path

import pytest
import torch

from benchmark import run, spec, window, work

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


def _python(code: str, cwd=ROOT, timeout=300):
    return subprocess.run([sys.executable, "-c", code], cwd=cwd,
                          capture_output=True, text=True, timeout=timeout)


def _tiny(name: str, n: int = 512):
    """The cell `name` at a size the CPU factors in a second."""
    cell = spec.load_cell(name)
    cell.traffic = dict(cell.traffic, n=n)
    return cell


def test_forbidden_names_compare_whole_top_level_names():
    assert run.forbidden_modules(["conflux_tpu_torch.lu.single", "torch",
                                  "jaxtyping", "flaxen"]) == []
    assert run.forbidden_modules(["conflux_tpu.lu", "jax.numpy", "jaxlib",
                                  "flax.linen"]) == [
        "conflux_tpu", "flax", "jax", "jaxlib"]


def test_a_run_loads_no_jax_and_not_the_jax_package():
    """Every cell loaded and run at a tiny size on the CPU, the way the
    command runs it after its look for a card, in a fresh interpreter."""
    code = f"""
import json, sys, time
from benchmark import run, spec
for name in {CELLS!r}:
    cell = spec.load_cell(name)
    cell.traffic = dict(cell.traffic, n=256)
    run.run_cell(cell, 7, 1.0, False, device="cpu", t0=time.monotonic())
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""
    done = _python(code)
    assert done.returncode == 0, done.stderr[-3000:]
    loaded = set(json.loads(done.stdout.strip().splitlines()[-1]))
    assert "conflux_tpu_torch" in loaded
    assert not loaded & set(run.FORBIDDEN), loaded & set(run.FORBIDDEN)


def test_reference_imports_nothing_of_the_program():
    src = (ROOT / "benchmark" / "reference.py").read_text()
    names = set()
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add((node.module or "").split(".")[0])
    assert names <= {"__future__", "contextlib", "torch"}, names
    done = _python("import sys, benchmark.reference, benchmark.inputs, "
                   "benchmark.work; print(sorted({m.split('.')[0] for m in "
                   "sys.modules}))")
    assert done.returncode == 0, done.stderr[-3000:]
    assert "conflux_tpu_torch" not in done.stdout
    assert "'conflux_tpu'" not in done.stdout


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves_to_its_files(name):
    cell = spec.load_cell(name)
    w = {x["name"]: x for x in BENCH["workloads"]}[name]
    cfg = {c["name"]: c for c in BENCH["configs"]}[w["config"]]
    assert cell.config["name"] == w["config"]
    assert cell.config["reduced"] == cfg["reduced"]
    assert cell.traffic["n"] > 0 and cell.traffic["inputs"] >= 1
    assert "setup_s" in [m["name"] for m in cell.end_to_end]
    assert cell.per_layer
    reported = [m["name"] for m in cell.end_to_end]
    assert [m for m in reported if m != "setup_s"]
    for entry, reader in cell.per_layer:
        assert (reader.LAYER, reader.UNIT, reader.SOURCE) == (
            entry["layer"], entry["unit"], entry["source"])
        # a split quantity read by its stem's reader: the entry says what
        # it moves
        own = ROOT / "benchmark" / "metrics" / f"{entry['name']}.py"
        if own.is_file():
            assert reader.MOVES == entry["moves"]
        assert entry["moves"] in reported, (entry["name"], reported)
    A = cell.driver.judge_input(cell.config, 64, 1, 0, "cpu")
    got = cell.driver.readings(cell.config, A,
                               cell.driver.plain(cell.config, A))
    assert set(cell.limits) <= set(got)


def test_new_files_are_found_without_an_edit(tmp_path):
    """A configuration, a traffic mix, a cell's limits and a per-layer
    metric added as new files (and entries of BENCHMARK.json) are found
    by name."""
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    b = tmp_path / "benchmark"
    cfg = json.loads((b / "configs" / "lu-f32-high.json").read_text())
    cfg.update(name="lu-f32-hpl", input={"generator": "uniform",
                                         "low": -0.5, "high": 0.5})
    (b / "configs" / "lu-f32-hpl.json").write_text(json.dumps(cfg))
    (b / "traffic" / "n1024.json").write_text(json.dumps(
        {"n": 1024, "loop": "closed", "callers": 1, "inputs": 1,
         "checked": 1, "why": "test"}))
    cfg.update(name="lu-f32-defaults", call={"v": 128,
                                             "precision": "highest"})
    (b / "configs" / "lu-f32-defaults.json").write_text(json.dumps(cfg))
    for cell in ("lu.hpl.n1024", "lu.defaults.n1024"):
        (b / "limits" / f"{cell}.json").write_text(
            (b / "limits" / "lu.n16384.json").read_text())
    # a metric that works out its own work from the cell's configuration
    # and N: the K2 products' operations per factorization
    (b / "metrics" / "zz_new_metric.py").write_text(
        'from benchmark import work\n\nLAYER = "device"\nUNIT = "GFLOP"\n'
        'SOURCE = "program_counter"\nMOVES = "factor_ms"\n\n\n'
        'def compute(s):\n'
        '    calls = work.k2_calls(s["config"]["work_path"], s["n"],\n'
        '                          s["config"]["call"]["v"])\n'
        '    if calls is None:\n'
        '        return None\n'
        '    return sum(2e-9 * m * k * nn for m, k, nn in calls)\n')
    for name in ("lu-f32-hpl", "lu-f32-defaults"):
        bench["configs"].append(dict(
            bench["configs"][0], name=name,
            file=f"benchmark/configs/{name}.json"))
    for cell, config in (("lu.hpl.n1024", "lu-f32-hpl"),
                         ("lu.defaults.n1024", "lu-f32-defaults")):
        bench["workloads"].append({"name": cell, "config": config,
                                   "traffic": "n1024", "chips": 1,
                                   "why": "test"})
    # the 'highest' cell reads every per-layer metric there is
    for m in bench["per_layer"]:
        m.get("workloads", []).append("lu.defaults.n1024")
    bench["per_layer"].append({"name": "zz_new_metric", "unit": "GFLOP",
                               "better": "lower",
                               "source": "program_counter",
                               "layer": "device", "moves": "factor_ms",
                               "workloads": ["lu.hpl.n1024",
                                             "lu.defaults.n1024"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.load_cell("lu.hpl.n1024", root=tmp_path)
    assert cell.traffic["n"] == 1024
    assert cell.config["input"]["low"] == -0.5
    names = [m["name"] for m, _ in cell.per_layer]
    assert "zz_new_metric" in names
    got = run.per_layer_metrics(cell, run.summary_of(
        cell, 20.0, 19.0, _synthetic_trace()))
    flops = sum(2e-9 * m * k * nn for m, k, nn in
                work.k2_calls("crout", 1024, 1536))
    assert got["zz_new_metric"]["value"] == pytest.approx(flops)
    # every reader computes on a precision and a tile the benchmark's
    # cells do not use ('highest', v = 128), the new metric too
    cell = spec.load_cell("lu.defaults.n1024", root=tmp_path)
    got = run.per_layer_metrics(cell, run.summary_of(
        cell, 20.0, 19.0, _synthetic_trace()))
    assert set(got) == {m["name"] for m, _ in cell.per_layer}
    assert 0 < got["k2_roofline"]["value"] <= 100
    # a split quantity without a file of its own is read by its stem's
    assert got["k2_roofline.chol"] == got["k2_roofline"]
    assert got["factor_ms.chol"]["value"] == 20.0
    assert got["zz_new_metric"]["value"] == pytest.approx(sum(
        2e-9 * m * k * nn for m, k, nn in work.k2_calls("crout", 1024, 128)))
    # the cells already there are left as they were
    assert "zz_new_metric" not in [
        m["name"] for m, _ in spec.load_cell("lu.n16384",
                                             root=tmp_path).per_layer]


def _synthetic_trace(ms: float = 10.0, count: int = 2) -> dict:
    """A traced run's summary (benchmark.trace.summarize) in which every
    kernel group took `ms` over `count` factorizations."""
    from benchmark import trace

    groups = {label: {"ms": ms, "launches": 10} for label, _ in trace.GROUPS}
    return {"count": count, "window_s": 0.05, "busy_s": 0.01,
            "kernels": 10 * len(groups), "groups": groups,
            "device_ops": [], "idle_gaps": []}


@pytest.mark.parametrize("path,precision", [
    ("crout", "high"), ("cholesky", "bf16"), ("crout", "highest"),
    ("crout", "fp8"), ("stepped", "high")])
def test_every_reader_computes_or_finds_nothing(path, precision):
    """Each per-layer reader of each cell, on a synthetic trace, with the
    configuration's step loop and precision replaced: a number, or None
    where the work has no such path or precision; never an error, and no
    share of a roofline over 100 %."""
    for name in CELLS:
        cell = spec.load_cell(name)
        cell.config = dict(cell.config, work_path=path, call=dict(
            cell.config["call"], precision=precision))
        values = run.per_layer_metrics(cell, run.summary_of(
            cell, 1e3, 900.0, _synthetic_trace(ms=2e5)))
        # by quantity: a split name `<quantity>.<part>` is its stem's
        got = {m.split(".")[0]: v for m, v in values.items()}
        assert "host_issue_ms" in got and "k1_ms" in got
        known = path in work.PATHS
        assert ("k1_roofline" in got) == known
        assert ("k2_roofline" in got) == (known and precision in work.PRODUCT)
        for m, v in values.items():
            assert math.isfinite(v["value"]), m
            if m.split(".")[0].endswith("_roofline"):
                assert 0 < v["value"] <= 100, (m, v)


@pytest.mark.parametrize("n", [32768, 16384, 4096, 5000])
def test_work_follows_chip_smokes_step_loops(n):
    import chip_smoke

    v = 1536
    for path in ("crout", "cholesky"):
        assert work.k1_blocks(path, n, v) == chip_smoke.k1_blocks(path, n, v)
        want = chip_smoke.loop_launches(path, n, v)
        got = work.launches(path, n, v)
        assert got["rank1_panel"] == want["rank1_panel"]
        assert got["sub_matmul_bigk"] == want["sub_matmul_bigk"]
    if n == 32768:
        assert chip_smoke.PATH_LAUNCHES["crout"]["sub_matmul_bigk"] == 41
        assert len(work.k2_calls("crout", n, v)) == 41
    # the big-K products' operations add up to the factorization's:
    # crout's panel and refresh products are the whole 2/3 n^3 less the
    # panels' own, Cholesky's the 1/3 n^3 less the tiles' and TRSMs'
    flops = sum(2.0 * m * k * nn for m, k, nn in work.k2_calls("crout", n, v))
    assert 0.5 < flops / (2.0 / 3.0 * n ** 3) < 1.0
    # IEEE fp32 products ('highest') at the fp32 peak take longer than the
    # three bf16 passes of 'high'; no work for a path or precision not
    # counted here
    assert (work.k2_least_ms("crout", n, v, "highest")
            > work.k2_least_ms("crout", n, v, "high"))
    assert work.k1_blocks("stepped", n, v) is None
    assert work.k1_least_ms("stepped", n, v) is None
    assert work.k2_least_ms("stepped", n, v, "high") is None
    assert work.k2_least_ms("crout", n, v, "fp8") is None
    assert work.launches("stepped", n, v) is None


def test_window_arithmetic():
    walls = [0.050 + 0.001 * (i % 7) for i in range(400)] + [0.2] * 10
    assert window.factor_ms(30.0, 600) == pytest.approx(50.0)
    q = statistics.quantiles(walls, n=100, method="inclusive")[94]
    assert window.p95_ms(walls) == pytest.approx(1e3 * q)
    # the tail of ALL samples: ten slow calls among 410 move the 95th
    # percentile no further than the 97.6th would be moved
    assert window.p95_ms(walls) < 200.0
    assert window.p95_ms(walls[:20] + [0.2] * 2) == pytest.approx(
        1e3 * statistics.quantiles(walls[:20] + [0.2] * 2, n=100,
                                   method="inclusive")[94])
    counts = [0] * 10
    for seed in range(2000):
        r = window.Reservoir(2, seed)
        for i in range(10):
            r.offer(i)
        assert len(r.items) == 2 and len(set(r.items)) == 2
        for i in r.items:
            counts[i] += 1
    assert min(counts) > 300 and max(counts) < 500   # 400 each if uniform
    a, b = window.Reservoir(3, 2 ** 31 + 5), window.Reservoir(3, 2 ** 31 + 5)
    for i in range(50):
        a.offer(i)
        b.offer(i)
    assert a.items == b.items


def test_last_line_of_a_cpu_run():
    """The last-line writer fed a tiny-N loop on the CPU through the plain
    reference: exactly the contract's keys and then `checks`, the CPU
    named as the device, no metric, nothing timed."""
    cell = _tiny("lu.n16384")
    line = run.run_cell(cell, 2 ** 31 + 11, 1.0, False, device="cpu",
                        t0=time.monotonic(), factorizations=3)
    buf = io.StringIO()
    with redirect_stdout(buf):
        run.emit(line)
    got = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert list(got) == KEYS
    assert got["metrics"] == {}
    assert got["device"]["platform"] == "cpu"
    assert got["device"]["memory_peak_bytes"] is None
    assert got["attempted"] == 3 and got["failed"] == 0 and got["correct"]
    assert set(got["checks"]) == set(cell.limits)
    for c in got["checks"].values():
        assert c["value"] <= c["limit"]


def test_the_command_without_a_card_exits_nonzero():
    done = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", CELLS[0],
         "--seed", str(2 ** 31 + 3), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert done.returncode != 0
    assert done.stdout.strip() == ""
    assert "no CUDA card" in done.stderr


def test_the_command_needs_the_program(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark's
    files, the run exits non-zero and prints no result (here already at
    the look for a card)."""
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    done = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert done.returncode != 0 and done.stdout.strip() == ""


def _faulty(cell, fault: str):
    """The cell with its timed entry point broken underneath."""
    prepare = cell.driver.prepare

    def broken_prepare(config, n, device):
        entry = prepare(config, n, device)

        def call(A):
            out = entry(A)
            lu = isinstance(out, tuple)
            F = out[0] if lu else out
            n = F.shape[0]
            if fault == "unchanged":
                F = A.clone()
                return (F, torch.arange(n)) if lu else F
            F[n // 2, n // 3] *= -1        # one answer altered
            return out
        return call

    drv = type(cell.driver)("faulty_driver")
    drv.__dict__.update(cell.driver.__dict__)
    drv.prepare = broken_prepare
    cell.driver = drv
    return cell


@pytest.mark.parametrize("fault", ["unchanged", "altered"])
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_timed_path_is_not_correct(name, fault):
    cell = _faulty(_tiny(name), fault)
    line = run.run_cell(cell, 2 ** 31 + 99, 1.0, False, device="cpu",
                        t0=time.monotonic(), factorizations=2)
    assert line["correct"] is False
    assert line["failed"] >= 1


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_one_short_run_on_the_card(name):
    chips = {w["name"]: w["chips"] for w in BENCH["workloads"]}[name]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        pytest.skip(f"needs {chips} CUDA card(s)")
    done = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", name,
         "--seed", str(2 ** 31 + 77), "--seconds", "2", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert done.returncode == 0, done.stderr[-3000:]
    got = json.loads(done.stdout.strip().splitlines()[-1])
    assert list(got) == KEYS and got["correct"] is True
    assert got["device"]["platform"] == "gpu"


def _fails(cell, got: dict) -> bool:
    return not all(got[k] <= lim["limit"] for k, lim in cell.limits.items())


def _controls_fail(cell, n: int, device: str, seeds):
    """Each control, at size n, fails one of the cell's numbers on every
    seed, where the program passes them all."""
    drv, cfg = cell.driver, cell.config
    program = drv.prepare(cfg, None, None)
    for seed in seeds:
        A = drv.make_input(cfg, n, seed, 0, device)
        assert not _fails(cell, drv.readings(cfg, A, program(A)))
        for name, control in drv.controls(cfg).items():
            got = drv.readings(cfg, A, control(A))
            if name == "control_tf32" or cfg["judge"] == "lu":
                assert _fails(cell, got), (name, seed, got)


@pytest.mark.parametrize("name", [c for c in CELLS if c.startswith("lu.")])
def test_the_control_is_not_correct(name):
    """At N = 2048, two crout steps, the TF32 products of the control
    and the program's own 'bf16' products fail the LU's limits."""
    _controls_fail(spec.load_cell(name), 2048, "cpu", [2 ** 31 + 1])


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct_at_the_cells_size(name):
    """At the cell's own size, on the card, on three seeds: the program
    passes, and the program's own 'bf16' products fail a number, as the
    LU's TF32 reference does (on CONFCHOX's diagonally dominant fill the
    Cholesky's TF32 reference reads like a sound fp32 Cholesky)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cell = spec.load_cell(name)
    drv, cfg = cell.driver, cell.config
    program = drv.prepare(cfg, None, None)
    for seed in (2 ** 31 + 5, 2 ** 31 + 6, 2 ** 31 + 7):
        A = drv.make_input(cfg, cell.traffic["n"], seed, 0, "cuda")
        assert not _fails(cell, drv.readings(cfg, A, program(A)))
        for cname, control in drv.controls(cfg).items():
            got = drv.readings(cfg, A, control(A))
            if cname == "program_bf16" or cfg["judge"] == "lu":
                assert _fails(cell, got), (cname, seed, got)
        del A
        torch.cuda.empty_cache()
