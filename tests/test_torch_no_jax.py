"""The port imports nothing of JAX and nothing of the JAX package.

In a fresh interpreter with ``jax``, ``jaxlib`` and ``vistaf_tpu`` blocked
in ``sys.modules`` (an import of any of them raises), every module of
``vistaf_torch``, ``chip_smoke.py`` and ``chip_limb_ranks.py`` import, and ``python -m
vistaf_torch.runner.cli --help`` runs.  Imports made inside functions do
not run then, so every import statement of those files is also read from
its syntax tree.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import vistaf_torch

PKG = Path(vistaf_torch.__file__).resolve().parent
BLOCKED = ("jax", "jaxlib", "vistaf_tpu")

SCRIPT = f"""
import importlib, pkgutil, runpy, sys
for name in {BLOCKED!r}:
    sys.modules[name] = None
import vistaf_torch
names = sorted(m.name for m in pkgutil.walk_packages(vistaf_torch.__path__, "vistaf_torch."))
for name in names + ["chip_smoke", "chip_limb_ranks"]:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in {BLOCKED!r} and sys.modules[m] is not None)
assert not leaked, leaked
print("imported", len(names))
sys.argv = ["vistaf_torch.runner.cli", "--help"]
try:
    runpy.run_module("vistaf_torch.runner.cli", run_name="__main__")
except SystemExit as e:
    assert e.code == 0, e.code
"""


def _modules():
    return sorted(p for p in PKG.rglob("*.py") if "_build" not in p.parts)


def _sources():
    return [*_modules(), PKG.parent / "chip_smoke.py", PKG.parent / "chip_limb_ranks.py"]


def test_every_module_imports_with_jax_blocked():
    env = {**os.environ, "PYTHONPATH": str(PKG.parent)}
    out = subprocess.run([sys.executable, "-c", SCRIPT], capture_output=True, text=True,
                         env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    n = int(out.stdout.split("imported ", 1)[1].split()[0])
    # every module file but the package __init__ (imported as the root)
    assert n == len(_modules()) - 1, (n, len(_modules()))
    assert "usage: vistaf-torch" in out.stdout
    assert {"runner", "trainers"} <= {p.parent.name for p in _modules()}


def test_no_import_statement_names_jax_or_the_jax_package():
    bad = []
    for path in _sources():
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            bad += [f"{path.name}:{node.lineno} {n}" for n in names
                    if n.split(".")[0] in BLOCKED]
    assert not bad, bad
