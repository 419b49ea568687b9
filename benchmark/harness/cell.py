"""Discovery: everything that belongs to one configuration, traffic mix,
driver, system or metric sits in a file of its own, found by the name that
``BENCHMARK.json`` or a configuration's file gives it.

- ``BENCHMARK.json`` at the checkout's root: the cells (``workloads``) and
  the metrics, each metric's ``workloads`` naming the cells it reports in.
- a configuration: the JSON ``file`` that ``configs`` names; its
  ``system`` key names the module under ``benchmark/systems/`` that builds
  the system under test and checks its answers.
- a traffic mix: ``benchmark/traffic/<traffic>.json``; its ``driver`` key
  names the module under ``benchmark/drivers/`` that drives the entry.
- a metric: ``benchmark/metrics/<name>.py``, whose ``read(ctx)`` returns
  the metric's value, or None where it finds nothing to read.
"""
from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType
from typing import Dict, List

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
_LOADED: Dict[Path, ModuleType] = {}


def spec(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def workload(sp: dict, name: str) -> dict:
    for w in sp["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                   f"({', '.join(w['name'] for w in sp['workloads'])})")


def config(sp: dict, name: str, root: Path = ROOT) -> dict:
    for c in sp["configs"]:
        if c["name"] == name:
            with open(root / c["file"]) as f:
                return {**json.load(f), "name": name}
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def traffic(name: str, bench: Path = BENCH) -> dict:
    with open(bench / "traffic" / f"{name}.json") as f:
        return {**json.load(f), "name": name}


def module(kind: str, name: str, bench: Path = BENCH) -> ModuleType:
    """``benchmark/<kind>/<name>.py``, loaded once."""
    path = (bench / kind / f"{name}.py").resolve()
    if path not in _LOADED:
        if not path.exists():
            raise FileNotFoundError(f"no {kind} module {name!r} ({path})")
        mod_name = f"bench_{kind}_" + re.sub(r"\W", "_", name)
        sp = importlib.util.spec_from_file_location(mod_name, path)
        mod = importlib.util.module_from_spec(sp)
        sp.loader.exec_module(mod)
        _LOADED[path] = mod
    return _LOADED[path]


def metrics(sp: dict, cell: str, trace: bool) -> List[dict]:
    """The cell's metrics: its end-to-end ones untraced, its per-layer ones
    traced; a metric without ``workloads`` reports in every cell (a
    per-layer one: every cell that reports its ``moves``)."""
    if not trace:
        return [m for m in sp["end_to_end"] if cell in m.get("workloads", [cell])]
    e2e = {m["name"] for m in metrics(sp, cell, False)}
    return [m for m in sp["per_layer"]
            if cell in m.get("workloads", [cell] if m["moves"] in e2e else [])]
