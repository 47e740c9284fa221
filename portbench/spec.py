"""Find a cell's files by name: the workload, its configuration, its driver
and the readers of its per-layer metrics.

``BENCHMARK.json`` at the root of the checkout lists the cells and the
metrics; each name maps to a file of its own under ``portbench/``:

- ``workloads/<cell>.json``: the configuration's name, the traffic mix
  (its name and parameters), ``chips``, the driver's name, the limits of
  the output check, and ``why``;
- ``configs/<config>.json``: the model configuration as it is run;
- ``drivers/<driver>.py``: what a window drives, with ``run(cell, ...)``;
- ``metrics/<stem>.py``: the reader, ``read(obs)``, of the per-layer
  metrics whose names begin ``<stem>`` (``<stem>`` or ``<stem>.<cells>``).
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import re
from pathlib import Path
from typing import Any, Callable, Dict, List, NamedTuple

ROOT = Path(__file__).resolve().parent
CHECKOUT = ROOT.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _name(kind: str, name: str) -> str:
    if not NAME.match(name or ""):
        raise ValueError(f"{kind} name {name!r}: letters, digits, '_', '.' and '-', at most 64")
    return name


def load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


def benchmark() -> Dict[str, Any]:
    return load_json(CHECKOUT / "BENCHMARK.json")


def workload(name: str) -> Dict[str, Any]:
    return load_json(ROOT / "workloads" / f"{_name('workload', name)}.json")


def config(name: str) -> Dict[str, Any]:
    return load_json(ROOT / "configs" / f"{_name('config', name)}.json")


def driver(name: str):
    return importlib.import_module(f"portbench.drivers.{_name('driver', name)}")


def reader(name: str) -> Callable:
    """The ``read`` function of ``metrics/<stem>.py``, the stem being the
    metric's name before its first dot: ``mfu.segment`` and ``mfu.train``
    share ``metrics/mfu.py``, and read what their cells' drivers observed."""
    stem = _name("metric", name).split(".")[0]
    path = ROOT / "metrics" / f"{stem}.py"
    spec = importlib.util.spec_from_file_location(f"portbench.metrics.{stem}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


class Cell(NamedTuple):
    name: str
    workload: Dict[str, Any]    # workloads/<name>.json
    config: Dict[str, Any]      # configs/<config>.json
    end_to_end: List[Dict[str, Any]]  # BENCHMARK.json's metrics this cell reports
    per_layer: List[Dict[str, Any]]


def _reports(metric: Dict[str, Any], cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def cell(name: str, bench: Dict[str, Any] = None) -> Cell:
    """A cell of ``BENCHMARK.json`` with its files and its metrics: the
    end-to-end metrics that list it (or list no cells), and the per-layer
    metrics that list it, or list no cells and move one of those."""
    bench = benchmark() if bench is None else bench
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    wl = workload(name)
    for key in ("config", "chips"):
        if wl[key] != entry[key]:
            raise ValueError(f"{name}: {key} {wl[key]!r} in its file, {entry[key]!r} in "
                             "BENCHMARK.json")
    if wl["traffic"]["name"] != entry["traffic"]:
        raise ValueError(f"{name}: traffic {wl['traffic']['name']!r} in its file, "
                         f"{entry['traffic']!r} in BENCHMARK.json")
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    moved = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (name in m["workloads"] if "workloads" in m else m["moves"] in moved)]
    return Cell(name, wl, config(wl["config"]), e2e, layer)
