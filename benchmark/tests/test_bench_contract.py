"""``BENCHMARK.json`` against the benchmark's contract: its keys, names,
units and limits, and every file it names found by its name."""
import json
import re

import pytest

from conftest import BENCH, ROOT
from harness import cell

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
SP = json.loads((ROOT / "BENCHMARK.json").read_text())


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_size():
    assert set(SP) == {"command", "paths", "run_seconds", "configs", "workloads",
                       "end_to_end", "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= len(SP["command"]) <= 32 and all(_line(w) for w in SP["command"])
    assert 1 <= len(SP["paths"]) <= 16
    for p in SP["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert not p.endswith("_torch")
    assert isinstance(SP["run_seconds"], int) and 1 <= SP["run_seconds"] <= 51
    # a full check of 24 cells fits its 43200 s
    runs = 2 + 14 * 24
    assert runs * (SP["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_lines():
    names = [c["name"] for c in SP["configs"]] + [w["name"] for w in SP["workloads"]] \
        + [m["name"] for m in SP["end_to_end"] + SP["per_layer"]]
    assert all(NAME.match(n) for n in names)
    for kind in ("configs", "workloads"):
        assert len({x["name"] for x in SP[kind]}) == len(SP[kind])
    metrics = SP["end_to_end"] + SP["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for w in SP["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and _line(w["why"])
        assert w["chips"] in (1, 4)
    assert len({(w["config"], w["traffic"]) for w in SP["workloads"]}) == len(SP["workloads"])


def test_configs():
    files = set()
    for c in SP["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and c["file"].startswith("benchmark/")
        assert c["file"] not in files
        files.add(c["file"])
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        body = json.loads((ROOT / c["file"]).read_text())
        assert body["source"] == c["source"] and body["reduced"] == c["reduced"]
        assert any(w["config"] == c["name"] for w in SP["workloads"])


def test_metrics():
    keys = {"name", "unit", "better", "source"}
    e2e = {m["name"] for m in SP["end_to_end"]}
    assert "setup_s" in e2e
    for m in SP["end_to_end"]:
        assert set(m) - {"workloads"} == keys | {"bound"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert next(m for m in SP["end_to_end"] if m["name"] == "setup_s")["bound"] <= 0.25
    layers = set()
    for m in SP["per_layer"]:
        assert set(m) - {"workloads"} == keys | {"layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert _line(m["layer"]) and m["moves"] in e2e
        layers.add(m["layer"])
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    cells = {w["name"] for w in SP["workloads"]}
    for w in cells:
        reported = cell.metrics(SP, w, False)
        assert "setup_s" in {m["name"] for m in reported} and len(reported) >= 2
        assert cell.metrics(SP, w, True)
    for m in SP["end_to_end"] + SP["per_layer"]:
        assert set(m.get("workloads", cells)) <= cells


@pytest.mark.parametrize("w", [w["name"] for w in SP["workloads"]])
def test_every_cell_finds_its_files(w):
    work = cell.workload(SP, w)
    cfg = cell.config(SP, work["config"])
    tr = cell.traffic(work["traffic"])
    assert (BENCH / "systems" / f"{cfg['system']}.py").exists()
    assert (BENCH / "drivers" / f"{tr['driver']}.py").exists()
    for m in cell.metrics(SP, w, False) + cell.metrics(SP, w, True):
        assert hasattr(cell.module("metrics", m["name"]), "read")


def test_four_chip_cells_within_their_share():
    four = sum(w["chips"] == 4 for w in SP["workloads"])
    assert four <= max(1, len(SP["workloads"]) // 4)
