"""The phase spans of the single-card step loops (`profiler.span` in
`lu.single._getrf_crout`, every compaction, and
`cholesky.single.potrf_inplace`), the span table, and the benchmark's
reader of the device idle filed under them
(benchmark/metrics/step_py_idle_ms.py).

    python -m pytest tests/test_torch_spans.py -q
"""

from __future__ import annotations

import inspect
import types
from collections import Counter

import pytest
import torch
from torch._C._profiler import RecordScope
from torch.profiler import DeviceType, ProfilerActivity

from conflux_tpu_torch import profiler
from conflux_tpu_torch.cholesky import p25d as chol_p25d
from conflux_tpu_torch.cholesky.single import cholesky
from conflux_tpu_torch.cli import cholesky_miniapp
from conflux_tpu_torch.lu import p25d as lu_p25d
from conflux_tpu_torch.lu.single import lu_factor

N, V = 128, 32
STEPS = N // V
PHASES = {"lu": ("update", "panel", "solve", "compact"),
          "chol": ("update", "panel", "solve")}
# crout's other compactions record the spans of 'gather' ("lu")
COMPACTIONS = ("split", "swap")


def _input(family: str) -> torch.Tensor:
    g = torch.Generator().manual_seed(5)
    A = torch.rand(N, N, generator=g) + 5.0
    if family == "chol":
        A = A @ A.T + N * torch.eye(N)
    return A


def _factor(family: str, A: torch.Tensor):
    if family == "chol":
        return (cholesky(A, v=V, precision="highest", scheme="flat"),)
    return lu_factor(A, v=V, precision="highest", scheme="crout",
                     compaction="gather" if family == "lu" else family)


def _expected(family: str) -> dict:
    """span name: calls in one factorization."""
    want = {f"{family}.factor": 1}
    want.update({f"{family}.{p}": STEPS for p in PHASES[family]})
    return want


@pytest.fixture
def clean_profiler():
    profiler.enable(False)
    profiler.PC()
    yield
    profiler.enable(False)
    profiler.PC()


@pytest.mark.parametrize("family", ["lu", "chol", *COMPACTIONS])
def test_enabled_spans_fill_the_table(family, clean_profiler):
    A = _input(family)
    profiler.enable(True)
    _factor(family, A)
    got = profiler.snapshot()
    spans = "lu" if family in COMPACTIONS else family
    entry = f"{spans}.factor"
    want = {entry: 1}
    want.update({f"{entry}/{spans}.{p}": STEPS for p in PHASES[spans]})
    assert {path: c for path, (c, _, _) in got.items()} == want
    # phases tile the steps inside the entry span: their host time sums
    # to no more than the entry span's
    phases = sum(h for path, (_, h, _) in got.items() if "/" in path)
    assert 0 < phases <= got[entry][1]
    # no card: no stream time, and PP prints the host table alone
    assert all(d is None for _, _, d in got.values())
    assert profiler._GLOBAL.device_report() is None


@pytest.mark.parametrize("family", ["lu", "chol"])
def test_spans_under_a_torch_profiler_session(family, clean_profiler):
    """With the module off, a recording `torch.profiler` session turns
    the spans on as host ranges on the trace's clock, nested in the entry
    span, and leaves the region tree empty."""
    A = _input(family)
    with torch.profiler.profile(activities=[ProfilerActivity.CPU]) as prof:
        _factor(family, A)
    spans = [ev for ev in prof.events()
             if ev.name.startswith(("lu.", "chol."))]
    assert Counter(ev.name for ev in spans) == _expected(family)
    (entry,) = [ev for ev in spans if ev.name == f"{family}.factor"]
    for ev in spans:
        # an op's scope: a user-scope range would also put a device-side
        # annotation on a card's trace
        assert ev.device_type == DeviceType.CPU
        assert ev.scope == RecordScope.FUNCTION.value
        assert entry.time_range.start <= ev.time_range.start
        assert ev.time_range.end <= entry.time_range.end
    assert profiler._GLOBAL.root.children == {}


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["lu", "chol"])
def test_spans_on_the_card(family, clean_profiler):
    """Under a CPU and CUDA session the spans are host ranges alone: no
    device event carries their names (a trace reads every CUDA event as
    device work). Under enable(True) every span resolves stream time."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    A = _input(family).cuda()
    _factor(family, A)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        _factor(family, A)
        torch.cuda.synchronize()
    spans = [ev for ev in prof.events()
             if ev.name.startswith(("lu.", "chol."))]
    assert Counter(ev.name for ev in spans) == _expected(family)
    assert all(ev.device_type == DeviceType.CPU for ev in spans)
    profiler.enable(True)
    _factor(family, A)
    got = profiler.snapshot()
    assert len(got) == len(_expected(family))
    assert all(d is not None and d > 0 for _, _, d in got.values())


@pytest.mark.parametrize("family", ["lu", "chol", *COMPACTIONS])
def test_spans_leave_the_outputs_bit_identical(family, clean_profiler):
    A = _input(family)
    off = _factor(family, A)
    profiler.enable(True)
    on = _factor(family, A)
    with torch.profiler.profile(activities=[ProfilerActivity.CPU]):
        traced = _factor(family, A)
    for a, b, c in zip(off, on, traced):
        assert torch.equal(a, b) and torch.equal(a, c)


def test_off_spans_cost_no_profiler_work(monkeypatch, clean_profiler):
    """Off, span and region return the one shared null context and open
    no profiler range, NVTX range or CUDA event; the table stays
    empty."""
    opened = Counter()

    def counting(name):
        def call(*args, **kwargs):
            opened[name] += 1
            raise AssertionError(f"{name} opened while off")
        return call

    monkeypatch.setattr(profiler, "_RecordFunctionFast",
                        counting("profiler range"))
    monkeypatch.setattr(torch.cuda.nvtx, "range_push", counting("nvtx"))
    monkeypatch.setattr(torch.cuda, "Event", counting("Event"))
    assert profiler.span("lu.panel") is profiler._NULL
    assert profiler.region("step0_reduce") is profiler._NULL
    assert profiler.span("chol.solve") is profiler.span("lu.update")
    for family in ("lu", "chol"):
        _factor(family, _input(family))
    assert not opened
    assert profiler.snapshot() == {}


def test_report_keeps_its_format_and_the_device_table():
    p = profiler.Profiler()
    for name in ("lu.factor", "init_matrix"):
        p.enter(name)
        if name == "lu.factor":
            p.enter("lu.panel")
            p.leave()
        p.leave()
    outer = p.root.children["lu.factor"]
    outer.wall, outer.children["lu.panel"].wall = 2.0, 1.5
    p.root.children["init_matrix"].wall = 0.5
    assert p.report().splitlines() == [
        f"{'REGION':<40}{'CALLS':>10}{'WALL(s)':>12}{'%':>8}",
        f"{'lu.factor':<40}{1:>10}{2.0:>12.6f}{80.0:>8.1f}",
        f"{'  lu.panel':<40}{1:>10}{1.5:>12.6f}{60.0:>8.1f}",
        f"{'init_matrix':<40}{1:>10}{0.5:>12.6f}{20.0:>8.1f}"]
    assert p.device_report() is None
    outer.device, outer.children["lu.panel"].device = 0.25, 0.2
    assert p.snapshot() == {"lu.factor": (1, 2.0, 0.25),
                            "lu.factor/lu.panel": (1, 1.5, 0.2),
                            "init_matrix": (1, 0.5, None)}
    # the same layout, stream time in place of host wall; a region with
    # no events reads '-'
    assert p.device_report().splitlines() == [
        f"{'REGION':<40}{'CALLS':>10}{'DEVICE(s)':>12}{'%':>8}",
        f"{'lu.factor':<40}{1:>10}{0.25:>12.6f}{100.0:>8.1f}",
        f"{'  lu.panel':<40}{1:>10}{0.2:>12.6f}{80.0:>8.1f}",
        f"{'init_matrix':<40}{1:>10}{'-':>12}{'':>8}"]


def test_pp_prints_the_device_table_only_where_recorded(capsys,
                                                         clean_profiler):
    profiler.enable(True)
    with profiler.span("lu.factor"):
        pass
    profiler.PP()
    out = capsys.readouterr().out
    assert "WALL(s)" in out and "DEVICE(s)" not in out
    profiler._GLOBAL.root.children["lu.factor"].device = 1e-3
    profiler.PP()
    out = capsys.readouterr().out
    assert out.count("REGION") == 2 and "DEVICE(s)" in out


def test_rank_programs_take_span_as_their_hook():
    for fn in (lu_p25d._local_lu_25d, chol_p25d._local_cholesky_25d_unrolled):
        assert inspect.signature(fn).parameters["region"].default is \
            profiler.span
    assert not hasattr(profiler, "no_region")
    assert not hasattr(profiler, "device_trace")


def test_cholesky_miniapp_profile_prints_the_step_spans(capsys,
                                                        clean_profiler):
    """-g 1x1x1 runs the flat Cholesky: --profile prints the timed reps'
    tree with the step spans, then the fenced substep table."""
    rc = cholesky_miniapp.main(["-N", "64", "-v", "16", "-g", "1x1x1",
                                "-r", "2", "--profile", "--platform",
                                "cpu"])
    out = capsys.readouterr().out
    assert rc == 0
    timed, substeps = out.split("cholesky_profiled_total")
    timed = timed[timed.index("REGION"):].splitlines()[1:-1]
    rows = Counter()
    for line in timed:
        rows[line.split()[0]] += int(line.split()[1])
    assert rows["chol.factor"] == 3          # the warm-up and two reps
    for phase in PHASES["chol"]:
        assert rows[f"chol.{phase}"] == 3 * 64 // 16
    assert "step1_potrf" in substeps and "chol." not in substeps


# -- the benchmark's reader: step_py_idle_ms ----------------------------------


def _event(name, start, end, device=DeviceType.CPU):
    return types.SimpleNamespace(
        name=name, device_type=device, is_async=False,
        time_range=types.SimpleNamespace(start=start, end=end))


def _reader(name="step_py_idle_ms"):
    from benchmark import spec

    return spec.metric_reader(name, spec.BENCH_DIR)


def test_step_py_idle_ms_reads_the_gaps_under_a_span():
    """Device gaps (µs) whose middle lies inside a span with no op open
    count; one under aten::mm and one outside every span do not."""
    from benchmark import trace

    cuda = DeviceType.CUDA
    events = [
        _event("lu.factor", 0, 100), _event("lu.panel", 10, 50),
        _event("aten::mm", 60, 70),
        _event("k", 0, 10, cuda), _event("k", 30, 35, cuda),    # 20 in panel
        _event("k", 40, 62, cuda),                             # 5 in panel
        _event("k", 68, 80, cuda),                             # 6 under mm
        _event("k", 90, 95, cuda),                             # 10 in factor
        _event("k", 120, 130, cuda),                           # 25 outside
    ]
    t = trace.summarize(events, count=2, window_s=1e-4)
    gaps = dict(t["idle_gaps"])
    assert gaps["lu.panel"] == pytest.approx(25e-6)
    assert gaps["aten::mm"] == pytest.approx(6e-6)
    assert gaps["host Python, no op open"] == pytest.approx(25e-6)
    for name in ("step_py_idle_ms", "step_py_idle_ms.chol"):
        got = _reader(name).compute({"trace": t})
        assert got == pytest.approx(1e3 * 35e-6 / 2)


def test_step_py_idle_ms_on_lists_without_a_span():
    from benchmark import trace

    read = _reader().compute
    short = {"count": 2, "idle_gaps": [["aten::mm", 0.3],
                                       ["host Python, no op open", 0.2]]}
    assert read({"trace": short}) == 0.0
    full = {"count": 2, "idle_gaps": [[f"aten::op{i}", 0.1]
                                      for i in range(trace.TOP)]}
    assert read({"trace": full}) is None
    full["idle_gaps"][-1] = ["chol.update", 0.004]
    assert read({"trace": full}) == pytest.approx(2.0)
