"""A run without a card exits non-zero with no result; nothing the
benchmark runs loads JAX, the JAX package or the scripts that reach them;
the reference loads nothing of the program."""
import json
import os
import subprocess
import sys

from conftest import BENCH, ROOT
from harness import guard


def test_names_compare_whole_by_their_top_level():
    mods = ["vistaf_torch", "vistaf_torch.ops", "jaxtyping", "jax.numpy", "flax.linen",
            "bench_torch_extra", "chip_smoke"]
    assert guard.loaded(modules=mods) == ["chip_smoke", "flax.linen", "jax.numpy"]


def _python(code, env=None):
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, env={**os.environ, **(env or {})}, timeout=300)


def test_run_without_a_card_fails_and_prints_no_result():
    p = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload", "streams640.step",
                        "--seed", "2147483648", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                       capture_output=True, text=True, timeout=300,
                       env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert p.returncode != 0
    assert not any(line.startswith("{") for line in p.stdout.splitlines())
    assert "No result" in p.stderr


def test_run_in_a_tree_without_the_program_fails(tmp_path):
    import shutil
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "streams640.step",
                        "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert not any(line.startswith("{") for line in p.stdout.splitlines())


def test_reference_loads_nothing_of_the_program():
    code = ("import sys; sys.path[:0] = [%r, %r]; import refrun, refcheck; "
            "import plainref.pipelines.multimodal; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))"
            % (str(BENCH / "reference"), str(BENCH)))
    p = _python(code)
    assert p.returncode == 0, p.stderr
    top = set(json.loads(p.stdout.strip().replace("'", '"')))
    assert not top & {"vistaf_torch", "vistaf_tpu", "jax", "jaxlib", "flax", "chip_smoke",
                      "bench_torch"}


def test_harness_and_systems_load_no_jax():
    code = ("import sys; sys.path[:0] = [%r, %r, %r]; from harness import cell, devtrace, "
            "scenes; import run; "
            "[cell.module(k, n) for k, n in (('systems', 'multimodal'), ('systems', 'streaming'), "
            "('drivers', 'closed_loop'))]; "
            "import vistaf_torch.pipelines.multimodal, vistaf_torch.pipelines.streaming, "
            "vistaf_torch.parallel; from harness import guard; print(guard.loaded())"
            % (str(ROOT), str(BENCH / "reference"), str(BENCH)))
    p = _python(code)
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip().splitlines()[-1] == "[]"
