"""Cells, configurations, traffic mixes, limits and metric readers, found by name.

`BENCHMARK.json` at the checkout's root names each cell's configuration
and traffic mix; their files are `port_bench/configs/<config>.json` and
`port_bench/traffic/<traffic>.json`. A traffic file names its driver,
`port_bench/drivers/<driver>.py`, which the harness imports by that name. A
per-layer metric is read by `port_bench/metrics/<metric>.py` (loaded from
its path: metric names hold dots), whose `read(record)` returns a number or
None. The limits of a configuration's check under a driver are
`port_bench/limits/<config>.<driver>.json`. Adding any of these is adding a
file; no file here changes.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

PACKAGE = Path(__file__).resolve().parent
ROOT = PACKAGE.parent


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return _json(root / "BENCHMARK.json")


@dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    limits: dict
    end_to_end: list  # the cell's end-to-end metric entries
    per_layer: list  # the cell's per-layer metric entries
    seed: int = 0
    device: str = "cuda"


def metric_applies(metric: dict, cell: str, e2e_names: set) -> bool:
    """Whether a cell reports `metric`: it lists the cell, or, without a
    `workloads` key, the cell reports the end-to-end metric it moves (or, for
    an end-to-end metric without one, every cell)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in e2e_names


def load_cell(name: str, root: Path = ROOT, package: Path = PACKAGE) -> Cell:
    bench = benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json: {sorted(cells)}")
    w = cells[name]
    traffic = _json(package / "traffic" / f"{w['traffic']}.json")
    e2e = [m for m in bench["end_to_end"] if metric_applies(m, name, set())]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if metric_applies(m, name, e2e_names)]
    return Cell(name=name, chips=int(w["chips"]), config_name=w["config"],
                config=_json(package / "configs" / f"{w['config']}.json"), traffic_name=w["traffic"],
                traffic=traffic, limits=_json(package / "limits" / f"{w['config']}.{traffic['driver']}.json"),
                end_to_end=e2e, per_layer=per_layer)


def driver(cell: Cell):
    return importlib.import_module(f"port_bench.drivers.{cell.traffic['driver']}")


def metric_reader(name: str, package: Path = PACKAGE):
    """The `read` function of `metrics/<name>.py`."""
    path = package / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"port_bench.metrics.{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
