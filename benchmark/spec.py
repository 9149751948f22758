"""A cell's pieces, each found by its name in BENCHMARK.json.

  * the cell: BENCHMARK.json's `workloads` entry (configuration, traffic
    mix, chips);
  * the configuration: the file its `configs` entry names;
  * the traffic mix: traffic/<traffic>.json;
  * the driver that runs the configuration: drivers/<driver>.py, named in
    the configuration;
  * the limits of the numbers that decide `correct`: limits/<cell>.json;
  * the end-to-end metrics that the cell reports, and the per-layer
    metrics, each read by metrics/<metric>.py: the entries of
    BENCHMARK.json whose `workloads` list the cell, or that have none.
    A name `<quantity>.<part>` is one quantity split by the end-to-end
    metric it moves (`k1_ms` moves `factor_ms`, `k1_ms.chol` moves
    `peak_gib`): without a file of its own it is read by
    metrics/<quantity>.py, and its entry, not the reader, says what it
    moves.

A later change adds a cell, a configuration, a mix or a metric as new
files and entries; nothing here names one.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent


def load_module(path: Path, name: str) -> ModuleType:
    """The Python file at `path`, imported under `name`."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(f"no module file {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    driver: ModuleType
    end_to_end: list
    per_layer: list = field(default_factory=list)   # (entry, module)


def _listed(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def metric_reader(name: str, here: Path) -> ModuleType:
    """The reader of the per-layer metric `name`: metrics/<name>.py, or
    for a split quantity `<quantity>.<part>` without a file of its own,
    metrics/<quantity>.py."""
    path = here / "metrics" / f"{name}.py"
    if not path.is_file():
        path = here / "metrics" / f"{name.split('.')[0]}.py"
    return load_module(path, "benchmark_metric_"
                       + path.stem.replace(".", "_"))


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell `name` of root/BENCHMARK.json, with its files under
    root/benchmark."""
    root = Path(root)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    here = root / BENCH_DIR.name
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    traffic = json.loads((here / "traffic" / f"{w['traffic']}.json")
                         .read_text())
    limits = json.loads((here / "limits" / f"{name}.json").read_text())
    driver = load_module(here / "drivers" / f"{config['driver']}.py",
                         f"benchmark_driver_{config['driver']}")
    per_layer = [(m, metric_reader(m["name"], here))
                 for m in bench["per_layer"] if _listed(m, name)]
    return Cell(name=name, chips=w["chips"], config=config, traffic=traffic,
                limits=limits, driver=driver,
                end_to_end=[m for m in bench["end_to_end"]
                            if _listed(m, name)],
                per_layer=per_layer)
