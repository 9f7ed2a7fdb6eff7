"""Find a cell's pieces by the names in BENCHMARK.json.

A cell names a configuration and a traffic mix; the mix names its kind,
``harness/<kind>.py``; each metric names its reader.  Nothing here knows a
particular cell: a later cell, mix, kind, metric or configuration is a new
file and a new entry.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """A module of the benchmark loaded from its file (names may hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclasses.dataclass
class Cell:
    """One entry of ``workloads`` with everything it names."""
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list       # the cell's end-to-end metric entries
    per_layer: list        # the cell's per-layer metric entries
    limits: dict           # {number: limit} of the comparison deciding correct

    def kind(self):
        """The module of the traffic's kind, ``harness/<kind>.py``: its
        ``run(cell, args, device, t_start)``, ``reference(cell, args,
        device, ctx)``, ``numbers(program, ref)``, ``LIMITS`` (the names of
        the numbers it compares) and ``summary(ctx)`` (lines for standard
        error).  Imported as a module of the package, so that it has one
        module object in a process and its relative imports hold."""
        return importlib.import_module(
            f"torchbench.harness.{self.traffic['kind']}")

    def reader(self, metric: dict):
        """The ``read(ctx)`` function of a metric's reader."""
        path = BENCH / "metrics" / f"{metric['name']}.py"
        return load_module(path, f"torchbench_metric_{metric['name']}").read

    def reference(self):
        path = BENCH / "reference" / f"{self.config['name']}.py"
        return load_module(path, f"torchbench_reference_{self.config['name']}")

    def work(self):
        path = BENCH / "work" / f"{self.config['name']}.py"
        return load_module(path, f"torchbench_work_{self.config['name']}")


def _reports(metric: dict, cell: str, e2e_names: set) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric["moves"] in e2e_names


def load_cell(name: str) -> Cell:
    bench = load_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                       f"{sorted(cells)}")
    entry = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(ROOT / configs[entry["config"]]["file"])
    traffic = load_json(BENCH / "traffic" / f"{entry['traffic']}.json")
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _reports(m, name, e2e_names)]
    limits = load_json(BENCH / "limits" / f"{name}.json")["limits"]
    return Cell(name, entry["chips"], config, traffic, e2e, per_layer, limits)
