"""Everything a run needs, found by name: the cell and its configuration
in ``BENCHMARK.json``, ``configs/<config>.json``,
``workloads/<cell>.json``, ``drivers/<driver>.py`` and
``metrics/<metric>.py``. Adding a cell, a configuration or a per-layer
metric adds files and entries; nothing here changes."""

from __future__ import annotations

import importlib
import importlib.util
import json
import pathlib
from typing import Callable, Dict, List

ROOT = pathlib.Path(__file__).resolve().parent.parent
PACKAGE = pathlib.Path(__file__).resolve().parent


def load(root: pathlib.Path = ROOT) -> Dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _named(entries: List[Dict], name: str, what: str) -> Dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def cell(bench: Dict, name: str) -> Dict:
    return _named(bench["workloads"], name, "cell")


def config(bench: Dict, name: str, root: pathlib.Path = ROOT) -> Dict:
    entry = _named(bench["configs"], name, "configuration")
    return json.loads((root / entry["file"]).read_text())


def workload(name: str, package: pathlib.Path = PACKAGE) -> Dict:
    return json.loads((package / "workloads" / f"{name}.json").read_text())


def driver(name: str):
    return importlib.import_module(f"outfitbench.drivers.{name}")


def end_to_end(bench: Dict, cell_name: str) -> List[Dict]:
    """The end-to-end metrics a cell reports."""
    return [m for m in bench["end_to_end"] if cell_name in m.get("workloads", [cell_name])]


def per_layer(bench: Dict, cell_name: str) -> List[Dict]:
    """The per-layer metrics a traced run of the cell reports: those that
    list it, and those without a list that move one of its end-to-end
    metrics."""
    moved = {m["name"] for m in end_to_end(bench, cell_name)}
    return [m for m in bench["per_layer"]
            if cell_name in m.get("workloads", ())
            or ("workloads" not in m and m["moves"] in moved)]


def reader(name: str, package: pathlib.Path = PACKAGE) -> Callable:
    """``metrics/<name>.py``'s ``read(record)``, which returns the metric's
    value or None where the record holds nothing to read."""
    path = package / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"outfitbench_metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
