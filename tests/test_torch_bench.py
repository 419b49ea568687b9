"""``bench_torch.py`` on the CPU: the round statistics its rows report
(``vistaf_torch.utils.profiling``: the median of the round medians, the
tail percentile a sample count can show, the rounds' spread) on fixed
arrays; the default suite built with ``device="cpu"`` at one round of one
call in a fresh interpreter, which must import nothing of JAX or of the JAX
package and whose last line must carry ``bench.py``'s keys and pass its
JAX-record gate; and ``main`` exiting non-zero, printing no row, without a
card.  The card's runs are the script's own: ``python3 bench_torch.py
[suite]``.
"""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import bench_torch
from vistaf_torch.utils import profiling
from torch_threads import single_torch_thread  # noqa: F401  (autouse)

ROOT = Path(bench_torch.__file__).resolve().parent
BLOCKED = ("jax", "jaxlib", "vistaf_tpu")
BENCH_PY_KEYS = ("metric", "value", "unit", "vs_baseline", "reps", "iters_per_rep")
ROW_KEYS = ("row", "suite", "what", "p50_ms", "tail", "tail_ms", "round_medians_ms",
            "spread_ms", "samples", "card", "correct", "gate", "route")
# the default suite at one round of one call (the gate's call is the only
# warm-up), one PyTorch thread
SCRIPT = f"""
import json, sys, torch
torch.set_num_threads(1)
import bench_torch
lines = bench_torch.run_suite("default", "cpu", rounds=1, iters=1, warmup=1)
leaked = sorted(m for m in sys.modules if m.split(".")[0] in {BLOCKED!r})
print(bench_torch.dumps({{"lines": lines, "leaked": leaked}}))
"""


@pytest.mark.parametrize("n, want", [(1, None), (10, None), (11, 9), (12, 16), (20, 50),
                                     (30, 66), (99, 89), (100, 90), (400, 90)])
def test_tail_percentile_keeps_ten_samples_beyond(n, want):
    q = profiling.tail_percentile(n)
    assert q == want
    if q is not None:
        assert n - int(np.ceil(q / 100 * n)) >= 10


def test_round_stats_on_fixed_rounds():
    rounds = [[3.0, 1.0, 2.0, 10.0], [4.0, 5.0, 6.0, 7.0], [2.0, 2.0, 2.0, 2.0]]
    st = profiling.round_stats(rounds)
    assert st["round_medians_ms"] == [2.5, 5.5, 2.0]
    assert st["p50_ms"] == 2.5 and st["spread_ms"] == 3.5
    assert st["spread_share"] == pytest.approx(3.5 / 2.5)
    assert st["samples"] == 12 and st["tail"] == "p16"
    assert st["tail_ms"] == pytest.approx(np.percentile(np.concatenate(rounds), 16))


def test_round_stats_report_p90_from_100_samples():
    st = profiling.round_stats(np.arange(100.0).reshape(5, 20))
    assert st["round_medians_ms"] == [9.5, 29.5, 49.5, 69.5, 89.5]
    assert st["p50_ms"] == 49.5 and st["spread_ms"] == 80.0
    assert st["tail"] == "p90" and st["tail_ms"] == pytest.approx(89.1)
    assert st["samples"] == 100


def test_round_stats_name_no_tail_below_eleven_samples():
    st = profiling.round_stats([[1.0, 3.0], [2.0, 2.0]])
    assert st["tail"] is None and st["tail_ms"] is None
    assert st["p50_ms"] == 2.0 and st["spread_ms"] == 0.0 and st["samples"] == 4
    assert profiling.percentiles([1.0, 2.0, 3.0, 4.0], (50, 90)) == [2.5, pytest.approx(3.7)]


@pytest.mark.parametrize("key, want", [
    ("(anonymous namespace)::ecc_loop_kernel(float const*, float c", "ecc_loop_kernel"),
    ("void (anonymous namespace)::polyfit_kernel<6, true>(float co", "polyfit_kernel<6, true>"),
    ("void (anonymous namespace)::quantile_pass_kernel<true>(float c", "quantile_pass_kernel<true>"),
    ("void (anonymous namespace)::elementwise_kernel_with_index<int, at::native::arange_cuda_out"
     "(at::Scalar const&)", None),
    ("void at::native::(anonymous namespace)::max_pool_forward_nch", None),
    ("void at::native::vectorized_elementwise_kernel<4, at::native", None),
    ("Memcpy DtoH (Device -> Pageable)", None)])
def test_profile_window_names_the_hand_written_kernels(key, want):
    """csrc/*.cu keeps each kernel in a top-level anonymous namespace, as
    PyTorch keeps some of its own; a template's profiler key starts with its
    return type."""
    assert profiling._hand_written(key) == want


def test_hand_written_kernel_names_are_the_csrc_kernels():
    names = profiling._kernel_names()
    assert {"ecc_loop_kernel", "gn_loop_kernel", "inpaint_mean_kernel", "inpaint_steps_kernel",
            "polyfit_kernel", "quantile_range_kernel", "quantile_pass_kernel",
            "quantile_finish_kernel", "mad_pass_kernel", "median_mad_finish_kernel",
            "fused_temp_kernel", "unwrap_kernel", "ccl_tile_kernel", "ccl_border_kernel",
            "ccl_flatten_kernel", "set_conditional_kernel"} == names


@pytest.fixture(scope="module")
def default_run():
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    out = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT, capture_output=True,
                         text=True, env=env, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_default_suite_imports_nothing_of_jax(default_run):
    assert default_run["leaked"] == []


def test_default_suite_rows_and_their_order(default_run):
    lines = default_run["lines"]
    assert [line["row"] for line in lines] == ["640_call", "640"]
    for line in lines:
        assert set(ROW_KEYS) <= set(line), line["row"]
        assert line["suite"] == "default" and line["device"] == "cpu"
        assert line["clock"] == "host" and line["card"] is None
        # on the CPU the forward runs op by op
        assert line["route"] == "eager"
        assert line["profile"] == "not measured"
        assert line["rounds"] == line["iters_per_round"] == line["samples"] == 1
        assert line["round_medians_ms"] == [line["p50_ms"]] and line["spread_ms"] == 0.0
        assert line["fps"] == pytest.approx(1000.0 / line["p50_ms"])


def test_default_line_has_bench_py_keys(default_run):
    line = default_run["lines"][-1]
    assert set(BENCH_PY_KEYS) <= set(line)
    with open(ROOT / "bench_baseline.json") as f:
        baseline = json.load(f)["reference_cpu_fps_640x480"]
    assert line["value"] == pytest.approx(1000.0 / line["p50_ms"], rel=1e-12)
    assert line["vs_baseline"] == pytest.approx(line["value"] / baseline, rel=1e-12)
    assert line["vs_baseline"] == pytest.approx(line["value"] / 0.4993, rel=1e-4)
    # a CPU run's rate is not named as the card's
    assert line["unit"] == "frames/sec/cpu" and "frames/sec/cpu" in line["metric"]
    assert f"{line['p50_ms']:.2f} ms" in line["metric"]


def test_default_rows_pass_their_jax_record_gate(default_run):
    head, call = default_run["lines"][-1], default_run["lines"][0]
    for line in (head, call):
        assert line["correct"] is True, line["gate"]
        gate = line["gate"]
        assert gate["against"] == "jax_record" and gate["force_gated"] is True
        assert gate["force_gap"] <= 0.01
    jax = head["gate"]["jax"]
    assert jax["path"] == "640" and jax["undetermined"] == []
    assert jax["given_alignment"]["force_gap"] <= 0.01
    assert jax["free"]["carrier_bins_equal"] and jax["free"]["ecc_warp_gap_px"] < 0.05


@pytest.mark.parametrize("argv", [[], ["4k"], ["all", "--rounds", "2", "--out", "rows.json"]])
def test_main_without_a_card_exits_nonzero_and_prints_no_row(argv, capsys, monkeypatch,
                                                            tmp_path):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench_torch.main(argv) == 1
    out = capsys.readouterr()
    assert out.out == "" and "CUDA is not available" in out.err
    assert not (tmp_path / "rows.json").exists()


def test_no_import_statement_names_jax_or_the_jax_package():
    tree = ast.parse((ROOT / "bench_torch.py").read_text())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    names += [n.module or "" for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)]
    assert "chip_smoke" in names and "vistaf_torch" in {n.split(".")[0] for n in names}
    assert not [n for n in names if n.split(".")[0] in BLOCKED], names


def test_route_is_graph_where_every_forward_of_the_row_replays_one():
    """The temperature and multimodal rows name their route by the
    pipelines they run (``Row.routed``): ``graph`` on the card, where the
    temperature forward and ``step_fused`` replay their graphs; ``eager``
    on the CPU, without a forward, and where one forward (here a force
    pipeline with debug outputs) runs op by op."""
    from vistaf_torch.config import ForceConfig
    from vistaf_torch.pipelines.force import ForcePipeline
    from vistaf_torch.pipelines.multimodal import MultimodalPipeline
    from vistaf_torch.temperature.inference import TemperaturePipeline
    from vistaf_torch.utils.synthetic import (scaled_ftp_config, scaled_temp_config,
                                              synthetic_deploy_temp_weights)
    color, wide = synthetic_deploy_temp_weights(0)
    temp = TemperaturePipeline(scaled_temp_config(240, 320).deploy(), color, wide,
                               device="cpu")
    force = ForcePipeline(scaled_ftp_config(240, 320).deploy(), ForceConfig(),
                          bench_torch.smoke.P2H_MODEL, bench_torch.smoke.FORCE_MODEL,
                          device="cpu")
    mm = MultimodalPipeline(force, temp)
    rows = {"temp4k": (temp,), "mm4k_call": (force.ftp, temp), "mm4k_scalars": (mm,)}
    for routed in rows.values():
        assert bench_torch.forward_route(routed) == {"route": "eager"}
    force.ftp.device = temp.device = torch.device("cuda")     # the route rule alone
    for routed in rows.values():
        assert bench_torch.forward_route(routed) == {"route": "graph"}
    assert bench_torch.forward_route(()) == {"route": "eager"}
    force.ftp.debug_outputs = True
    assert bench_torch.forward_route(rows["temp4k"]) == {"route": "graph"}
    for name in ("mm4k_call", "mm4k_scalars"):
        assert bench_torch.forward_route(rows[name]) == {"route": "eager"}
