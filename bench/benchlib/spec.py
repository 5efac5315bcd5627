"""Where a cell's files live, and how they are found by name.

``BENCHMARK.json`` at the checkout's root names every cell, configuration
and metric.  Everything that belongs to one of them sits in a file of its
own under ``bench/``, found by that name alone:

    bench/configs/<config>.json     a deployment: its system and sizes
    bench/workloads/<traffic>.json  a traffic mix: clients, sizes, mix
    bench/metrics/<metric>.py       one reader a metric, ``read(run)``
    bench/bounds/<kernel>.py        one kernel's operations and bytes
    bench/reference/<name>.py       a configuration's plain reference

So a later change adds a cell, a configuration or a metric by adding
files; nothing here names any of them.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
SPEC_FILE = ROOT / "BENCHMARK.json"


def load_spec() -> dict:
    return json.loads(SPEC_FILE.read_text())


def load_json(kind: str, name: str) -> dict:
    return json.loads((BENCH / kind / f"{name}.json").read_text())


_modules: Dict[Path, ModuleType] = {}


def load_module(kind: str, name: str) -> ModuleType:
    """``bench/<kind>/<name>.py`` as a module (names may hold dots, so the
    file is loaded by its path, not imported by a dotted name)."""
    path = BENCH / kind / f"{name}.py"
    mod = _modules.get(path)
    if mod is None:
        if not path.is_file():
            raise FileNotFoundError(path)
        spec = importlib.util.spec_from_file_location(f"bench_{kind}_{name}".replace(".", "_")
                                                      .replace("-", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _modules[path] = mod
    return mod


def applies(metric: dict, cell: str, spec: dict) -> bool:
    """Does ``metric`` (an entry of ``end_to_end`` or ``per_layer``) belong
    to ``cell``?  A ``workloads`` key lists its cells.  Without one, an
    end-to-end metric belongs to every cell, and a per-layer metric to every
    cell that reports the end-to-end metric it ``moves``: so a cell of a
    served model takes the per-layer metrics of its system's rate, and none
    of the image service's, with no entry naming it."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    if "moves" not in metric:
        return True
    return any(m["name"] == metric["moves"] and applies(m, cell, spec)
               for m in spec["end_to_end"])


def metrics_of(cell: str, spec: dict):
    """The ``(end_to_end, per_layer)`` entries that belong to ``cell``."""
    return ([m for m in spec["end_to_end"] if applies(m, cell, spec)],
            [m for m in spec["per_layer"] if applies(m, cell, spec)])


@dataclasses.dataclass
class Cell:
    """One entry of ``workloads`` with its configuration, traffic and metrics."""

    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def load_cell(name: str, spec: dict = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json``."""
    spec = spec or load_spec()
    entries = [w for w in spec["workloads"] if w["name"] == name]
    if not entries:
        raise KeyError(f"no workload {name!r} in {SPEC_FILE.name}; "
                       f"known: {[w['name'] for w in spec['workloads']]}")
    entry = entries[0]
    configs = {c["name"]: c for c in spec["configs"]}
    config = json.loads((ROOT / configs[entry["config"]]["file"]).read_text())
    end_to_end, per_layer = metrics_of(name, spec)
    return Cell(name=name, chips=int(entry["chips"]), config=config,
                traffic=load_json("workloads", entry["traffic"]),
                end_to_end=end_to_end, per_layer=per_layer)

