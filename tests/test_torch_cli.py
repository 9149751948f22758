"""Parity of the port's front ends (conflux_tpu_torch/cli, bench) with the
JAX package's (conflux_tpu/cli, bench), each run in this process through
its main() as a user runs it: the JAX miniapps on the 8-device CPU mesh
that tests/conftest.py sets up, the port's with --platform cpu (its P > 1
grids on ranks it starts through launch.run_ranks).

  * `_result_` lines field for field (algorithm, library, N, N_base, P,
    grid, unit, type, blocksize; the time values are each package's
    own and only need to be > 0), the residual within 3x of JAX's (each
    package's fp32 factor sits at its own roundoff from the exact one,
    as in tests/test_torch_dist_rest.py) and at most 1e-6;
  * the Cholesky helper's files byte for byte, and its comparison;
  * the sweep's CSV rows field for field but the time, and
    `plots.summarize` equal to JAX's on the same CSV.
"""

import csv
import re

import pytest
import torch

from conflux_tpu.bench import plots as jplots
from conflux_tpu.cli import cholesky_helper as jhelper
from conflux_tpu.cli import cholesky_miniapp as jchol_app
from conflux_tpu.cli import conflux_miniapp as jlu_app
from conflux_tpu.cli import sweep as jsweep
from conflux_tpu_torch.bench import plots as tplots
from conflux_tpu_torch.cli import _common
from conflux_tpu_torch.cli import cholesky_helper as thelper
from conflux_tpu_torch.cli import cholesky_miniapp as tchol_app
from conflux_tpu_torch.cli import conflux_miniapp as tlu_app
from conflux_tpu_torch.cli import sweep as tsweep

CPU = ["--platform", "cpu"]


def _results(capsys, main, argv):
    """main(argv)'s return code and its `_result_` lines, split into their
    ten fields."""
    capsys.readouterr()
    rc = main(argv)
    out = capsys.readouterr().out
    return rc, [line.split(" ", 1)[1].split(",")
                for line in out.splitlines() if line.startswith("_result_ ")]


def _same_results(jrows, trows, reps):
    assert len(jrows) == len(trows) == reps + 1, (jrows, trows)
    for j, t in zip(jrows, trows):
        assert len(t) == 10
        assert t[:8] + t[9:] == j[:8] + j[9:], (t, j)
    for t in trows[:-1]:
        assert t[6] == "time" and float(t[8]) > 0
    jres, tres = float(jrows[-1][8]), float(trows[-1][8])
    assert trows[-1][6] == "residual"
    assert tres <= 1e-6 and jres / 3 <= tres <= 3 * jres, (tres, jres)


@pytest.mark.parametrize("grid,kind", [("1x1x1", "strong"),
                                       ("2x2x1", "weak")])
def test_lu_miniapp_result_lines_match_jax(capsys, grid, kind):
    argv = ["-N", "128", "-b", "16", "-p", grid, "-r", "2", "-t", kind,
            "--validate"]
    rc_j, jrows = _results(capsys, jlu_app.main, argv)
    rc_t, trows = _results(capsys, tlu_app.main, argv + CPU)
    assert rc_j == rc_t == 0
    _same_results(jrows, trows, reps=2)


def test_cholesky_miniapp_result_lines_match_jax(capsys):
    argv = ["-N", "128", "-v", "16", "-g", "1x1x1", "-r", "1", "--validate"]
    rc_j, jrows = _results(capsys, jchol_app.main, argv)
    rc_t, trows = _results(capsys, tchol_app.main, argv + CPU)
    assert rc_j == rc_t == 0
    _same_results(jrows, trows, reps=1)


@pytest.mark.parametrize("app", ["lu", "cholesky"])
def test_miniapp_profile_prints_the_region_table(capsys, app):
    if app == "lu":
        argv = ["-N", "64", "-b", "16", "-p", "1x1x1", "-r", "1",
                "--profile"]
        rc = tlu_app.main(argv + CPU)
        names = ("lu_profiled_total", "step1_pivot", "step6_update")
    else:
        argv = ["-N", "64", "-v", "16", "-g", "1x1x1", "-r", "1",
                "--profile"]
        rc = tchol_app.main(argv + CPU)
        names = ("cholesky_profiled_total", "step1_potrf", "step4_update")
    out = capsys.readouterr().out
    assert rc == 0 and "REGION" in out
    for name in names:
        assert name in out


def _flags(capsys, main):
    """The option strings in main's usage line (argparse's -h output)."""
    capsys.readouterr()
    with pytest.raises(SystemExit):
        main(["-h"])
    usage = capsys.readouterr().out.split("options:")[0]
    return set(re.findall(r"\[(-{1,2}\w+)", usage))


@pytest.mark.parametrize("jmain,tmain,extra", [
    (jlu_app.main, tlu_app.main, {"--precision"}),
    (jchol_app.main, tchol_app.main, set()),
], ids=["conflux_miniapp", "cholesky_miniapp"])
def test_miniapp_flags_match_jax(capsys, jmain, tmain, extra):
    # the JAX flag set; the LU miniapp adds only --precision, which runs
    # the card's main path ('high') through the CLI
    jflags = _flags(capsys, jmain)
    assert jflags and _flags(capsys, tmain) == jflags | extra


def test_miniapp_refuses_the_card_it_does_not_have():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="--platform cpu"):
        tlu_app.main(["-N", "64", "-b", "16", "-p", "1x1x1"])
    with pytest.raises(ValueError):
        _common.setup_platform("tpu")
    assert _common.parse_grid("4x2x1") == (4, 2, 1)
    assert _common.parse_grid(None) is None
    with pytest.raises(ValueError):
        _common.parse_grid("4x2")


def test_cholesky_helper_files_match_jax(capsys, tmp_path):
    from conflux_tpu_torch.cholesky import cholesky
    from conflux_tpu_torch.io import load_matrix, save_matrix

    dj, dt = tmp_path / "j", tmp_path / "t"
    assert jhelper.main(["--generate", "48", "--dir", str(dj)]) == 0
    assert thelper.main(["--generate", "48", "--dir", str(dt)]) == 0
    for name in ("input_48.bin", "result_48.bin"):
        assert (dj / name).read_bytes() == (dt / name).read_bytes()
    A = torch.from_numpy(load_matrix(str(dt / "input_48.bin"), 48))
    L = cholesky(A, v=16)                      # float64 on the CPU
    save_matrix(str(dt / "output_48.bin"), L)
    capsys.readouterr()
    assert thelper.main(["--compare", "48", "--dir", str(dt)]) == 0
    assert "OK" in capsys.readouterr().out
    L[5, 3] += 1.0
    save_matrix(str(dt / "output_48.bin"), L)
    assert thelper.main(["--compare", "48", "--dir", str(dt)]) == 1
    assert "MISMATCH" in capsys.readouterr().out
    assert thelper.main([]) == 2


def _ini(path, csv_path):
    path.write_text(
        "[sweep_a]\nalgorithm = cholesky\ntype = strong\nsizes = 32\n"
        f"grid = 2x2x1\ntile = 8\nreps = 2\ncsv = {csv_path}\n"
        "[sweep_b]\nalgorithm = lu\ntype = weak\nsizes = 16\n"
        f"grid = 2x2x1\ntile = 8\nreps = 1\ncsv = {csv_path}\n"
        "[sweep_c]\nalgorithm = lu_single\nsizes = 48,64\ntile = 16\n"
        f"reps = 1\nprecision = high\ncsv = {csv_path}\n"
        "[other]\nalgorithm = lu\n")
    return str(path)


def test_sweep_csv_and_plots_match_jax(capsys, tmp_path):
    jcsv, tcsv = tmp_path / "j.csv", tmp_path / "t.csv"
    assert jsweep.main([_ini(tmp_path / "j.ini", jcsv)]) == 0
    assert tsweep.main([_ini(tmp_path / "t.ini", tcsv)] + CPU) == 0
    out = capsys.readouterr().out
    assert "_result_ lu,conflux-tpu,32,16,4,2x2x1,time,weak" in out
    with open(jcsv) as f:
        jrows = list(csv.reader(f))
    with open(tcsv) as f:
        trows = list(csv.reader(f))
    assert len(trows) == len(jrows) == 1 + 2 + 1 + 2
    assert trows[0] == jrows[0]
    for t, j in zip(trows[1:], jrows[1:]):
        assert t[:8] + t[9:] == j[:8] + j[9:], (t, j)
        assert float(t[8]) > 0
    for path in (jcsv, tcsv):
        assert tplots.summarize(tplots.load(str(path))) == \
            jplots.summarize(jplots.load(str(path)))
    capsys.readouterr()
    assert tplots.main([str(tcsv), "-o", str(tmp_path / "t.png")]) == 0
    tout = capsys.readouterr().out
    assert jplots.main([str(tcsv), "-o", str(tmp_path / "j.png")]) == 0
    jout = capsys.readouterr().out
    assert tout.replace("t.png", "j.png") == jout


def test_sweep_refuses_a_missing_config(tmp_path):
    assert tsweep.main([str(tmp_path / "none.ini")] + CPU) == 2
