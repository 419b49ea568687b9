"""One run of one benchmark cell of the PyTorch and CUDA port on the card.

    python3 benchmark/run.py --workload NAME --seed N --seconds S --trace 0|1

From the root of a checkout.  The cell (``BENCHMARK.json``'s
``workloads``) names a configuration, whose file names the system under
test (``benchmark/systems/<system>.py``), and a traffic mix
(``benchmark/traffic/<traffic>.json``), which names its driver
(``benchmark/drivers/<driver>.py``); each metric is read by
``benchmark/metrics/<name>.py``.

A run: makes its scenes and models from ``--seed`` on the card, builds the
system, warms up the cell's own inputs (the first call captures its CUDA
graph), then drives the entry in a closed loop for ``--seconds`` (with
``--trace 1`` for the traffic's ``trace_seconds`` under ``torch.profiler``)
and times every call on the host clock.  After the window: the peak device
memory, the program freed, every answer of the window held to the plain
reference (``benchmark/reference``), and the check that no JAX module was
loaded.  The last line of standard output is one JSON object: ``correct``,
``attempted`` (answers compared), ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones), ``device``,
with ``--trace 1`` ``breakdown``, and last ``checks``, each compared number
beside its limit, which also close standard error.  An earlier line gives
the split of ``setup_s``.  Without a card, with fewer cards than the cell
asks for, or with a forbidden module loaded, it exits non-zero and prints
no result.

The build caches live at fixed paths inside the checkout: the kernels'
``vistaf_torch/_build``, and ``benchmark/.cache`` for Triton and PyTorch
extensions.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
for _p in (ROOT, BENCH / "reference", BENCH):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))
CACHE = BENCH / ".cache"

from harness import cell, devtrace, guard  # noqa: E402


class Clock:
    """The split of the set-up: seconds by part, in the order first seen."""

    def __init__(self):
        self.parts = {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        t = time.perf_counter()
        try:
            yield
        finally:
            self.parts[name] = self.parts.get(name, 0.0) + time.perf_counter() - t


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def traced_window(driver, system, seconds, schedule):
    """The window under ``torch.profiler`` (host and card), reduced from its
    Chrome trace, written to ``TMPDIR`` and removed."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from vistaf_torch.utils import cuda_graph
    cuda_graph.note_profiler()           # keep WHILE graphs alive past a trace
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        win = driver.run(system, seconds, schedule, spans=True)
        torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json", prefix="bench_trace_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        tr = devtrace.load(path)
    finally:
        os.unlink(path)
    return win, tr


def run(argv=None, device=None, bench_root: Path = ROOT, out=sys.stdout):
    """One run; returns its exit code.  ``device`` given (a test on the
    CPU) skips the look for a card and the trace; the result is printed
    all the same."""
    args = parse(argv)
    # fixed cache directories inside the checkout, set before torch loads
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    # one process with few threads: the host's share of a step is serial
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    clock = Clock()
    sp = cell.spec(bench_root)
    work = cell.workload(sp, args.workload)
    cfg = cell.config(sp, work["config"], bench_root)
    traffic = cell.traffic(work["traffic"])
    with clock("imports_cuda"):
        import numpy as np
        import torch
        torch.set_num_threads(1)
        if device is None:
            if not torch.cuda.is_available() or torch.cuda.device_count() < work["chips"]:
                print(f"run.py: the cell {work['name']} needs {work['chips']} CUDA card(s); "
                      f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
                      f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} "
                      "found. No result.", file=sys.stderr)
                return 2
            device = torch.device("cuda", 0)
            torch.zeros(1, device=device)
            torch.cuda.synchronize()
        cuda = torch.device(device).type == "cuda"
        sysmod = cell.module("systems", cfg["system"])
        import vistaf_torch  # noqa: F401
    system = sysmod.System(cfg, traffic, args.seed, device, clock)
    driver = cell.module("drivers", traffic["driver"])
    driver.warm(system, clock)
    setup_s = time.perf_counter() - T0
    schedule = system.schedule(np.random.default_rng([args.seed, 2]))
    tr = None
    if args.trace:
        if not cuda:
            raise RuntimeError("a traced run reads the card's trace; there is no card")
        win, tr = traced_window(driver, system, float(traffic["trace_seconds"]), schedule)
    else:
        win = driver.run(system, args.seconds, schedule)
    if cuda:
        torch.cuda.synchronize()
        peak = int(torch.cuda.max_memory_allocated(device))
    system.free()
    t_check = time.perf_counter()
    verdict = system.check(win.calls)
    check_s = time.perf_counter() - t_check
    found = guard.loaded()
    if found:
        print(f"run.py: forbidden modules loaded: {', '.join(found)}. No result.",
              file=sys.stderr)
        return 3

    ctx = SimpleNamespace(window=win, trace=tr, setup_s=setup_s, cfg=cfg, traffic=traffic,
                          frames=win.frames, steps=len(win.calls) * getattr(system, "seq", 1))
    metrics = {}
    for m in cell.metrics(sp, work["name"], bool(args.trace)):
        value = cell.module("metrics", m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": int(work["chips"]), "memory_peak_bytes": peak if cuda else 0}
    result = {"correct": verdict["correct"], "attempted": verdict["compared"],
              "failed": verdict["failed"], "metrics": metrics, "device": dev}
    if tr is not None:
        dev["busy_s"] = devtrace.busy_us(tr) * 1e-6
        dev["window_s"] = tr.window_us * 1e-6
        result["breakdown"] = {"device_ops": devtrace.top_device_ops(tr),
                               "idle_gaps": devtrace.longest_gaps(tr)}
    if cuda:
        dev["power"] = power_limit()
    result["checks"] = verdict["numbers"]
    print(json.dumps({"setup_split_s": clock.parts, "setup_s": setup_s,
                      "window_s": win.seconds, "calls": len(win.calls),
                      "reference_check_s": check_s}), file=out)
    for name, v in verdict["numbers"].items():
        print(f"check {name} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    print(json.dumps(result), file=out)
    out.flush()
    return 0


if __name__ == "__main__":
    sys.exit(run())
