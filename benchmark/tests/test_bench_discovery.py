"""A configuration, a traffic mix, a cell and a per-layer metric added as
new files (and entries in ``BENCHMARK.json``) in a copy of the benchmark
are found with no edit to a file already there."""
import json
import shutil

from conftest import BENCH, ROOT
from harness import cell


def test_new_files_are_found(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache", "tests"))
    sp = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench = root / "benchmark"
    cfg = json.loads((bench / "configs" / "streams640.json").read_text())
    cfg["streams"] = 8
    (bench / "configs" / "streams640_8.json").write_text(json.dumps(cfg))
    tr = json.loads((bench / "traffic" / "step.json").read_text())
    tr["depths_rad"] = [0.0, 0.4, 0.9]
    (bench / "traffic" / "shallow.json").write_text(json.dumps(tr))
    (bench / "metrics" / "graph_launches_per_frame.py").write_text(
        "def read(ctx):\n    return 1.0\n")
    sp["configs"].append({"name": "streams640_8", "source": "a test",
                          "file": "benchmark/configs/streams640_8.json", "reduced": [],
                          "why": "a test"})
    sp["workloads"].append({"name": "streams640_8.shallow", "config": "streams640_8",
                            "traffic": "shallow", "chips": 1, "why": "a test"})
    sp["per_layer"].append({"name": "graph_launches_per_frame", "unit": "calls/frame",
                            "better": "lower", "source": "device_trace",
                            "layer": "utils.cuda_graph", "moves": "frames_per_s"})
    (root / "BENCHMARK.json").write_text(json.dumps(sp))

    sp2 = cell.spec(root)
    work = cell.workload(sp2, "streams640_8.shallow")
    assert cell.config(sp2, work["config"], root)["streams"] == 8
    assert cell.traffic(work["traffic"], bench)["depths_rad"] == [0.0, 0.4, 0.9]
    per_layer = {m["name"] for m in cell.metrics(sp2, "streams640_8.shallow", True)}
    assert "graph_launches_per_frame" in per_layer
    # a per-layer metric without ``workloads`` reports in every cell of its ``moves``
    assert "graph_launches_per_frame" in {m["name"] for m in
                                          cell.metrics(sp2, "streams640.step", True)}
    assert cell.module("metrics", "graph_launches_per_frame", bench).read(None) == 1.0
    assert cell.module("drivers", cell.traffic("shallow", bench)["driver"], bench).run
