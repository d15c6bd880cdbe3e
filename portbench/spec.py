"""``BENCHMARK.json`` and the files it names, found by name.

A cell names a configuration and a traffic mix; a configuration's file
names the driver that runs it (``system``); a per-layer metric is read by
``metrics/<name>.py``'s ``read(run)``. Adding a cell, a mix, a
configuration or a metric adds files and entries and edits none.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Callable, Optional

PACKAGE = Path(__file__).resolve().parent
#: The checkout's root: ``BENCHMARK.json`` lies there, and the port beside
#: this folder.
ROOT = PACKAGE.parent


class SpecError(ValueError):
    """A name that ``BENCHMARK.json`` or its files do not hold."""


def load_benchmark(root: Path = ROOT) -> dict:
    path = Path(root) / "BENCHMARK.json"
    if not path.is_file():
        raise SpecError(f"no BENCHMARK.json at {root}")
    return json.loads(path.read_text())


def _named(entries: list, name: str, what: str) -> dict:
    for entry in entries:
        if entry["name"] == name:
            return entry
    raise SpecError(f"no {what} named {name!r} in BENCHMARK.json")


def cell(bench: dict, name: str) -> dict:
    return _named(bench["workloads"], name, "workload")


def config(bench: dict, cell_entry: dict, root: Path = ROOT) -> dict:
    """The configuration's file, with its ``BENCHMARK.json`` entry under
    ``"entry"``."""
    entry = _named(bench["configs"], cell_entry["config"], "config")
    data = json.loads((Path(root) / entry["file"]).read_text())
    data["entry"] = entry
    return data


def traffic(name: str, package: Path = PACKAGE) -> dict:
    path = Path(package) / "traffic" / f"{name}.json"
    if not path.is_file():
        raise SpecError(f"no traffic mix {name!r} ({path.name})")
    return json.loads(path.read_text())


def reports(metric: dict, cell_entry: dict, bench: dict) -> bool:
    """Whether ``cell_entry`` reports ``metric``: the cells its
    ``workloads`` lists, or without that key every cell that reports the
    end-to-end metric it moves (an end-to-end metric without the key: every
    cell)."""
    if "workloads" in metric:
        return cell_entry["name"] in metric["workloads"]
    moves = metric.get("moves")
    if moves is None:
        return True
    return reports(_named(bench["end_to_end"], moves, "metric"), cell_entry, bench)


def cell_metrics(bench: dict, cell_entry: dict, trace: bool) -> list[dict]:
    """The metrics a run of the cell prints: the end-to-end ones, or with
    ``trace`` the per-layer ones."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if reports(m, cell_entry, bench)]


def driver(system: str) -> ModuleType:
    """``drivers/<system>.py``."""
    if not (PACKAGE / "drivers" / f"{system}.py").is_file():
        raise SpecError(f"no driver for system {system!r}")
    return importlib.import_module(f"portbench.drivers.{system}")


def reader(metric: str, package: Path = PACKAGE) -> Callable[[object], Optional[float]]:
    """``metrics/<metric>.py``'s ``read``: run record -> a number, or None
    where the run holds nothing to read."""
    path = Path(package) / "metrics" / f"{metric}.py"
    if not path.is_file():
        raise SpecError(f"no reader for metric {metric!r} ({path.name})")
    module_name = "portbench_metric_" + "".join(c if c.isalnum() else "_" for c in metric)
    spec = importlib.util.spec_from_file_location(module_name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
