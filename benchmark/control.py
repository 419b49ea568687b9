"""The control of a cell's comparison: the plain reference put in the
program's place and computed one precision below the configuration's
float32 (TF32 matmuls and convolutions), on the cell's own scenes and
schedule, held to the float32 reference by the same numbers that decide a
run's ``correct``.  It has to come out not correct; its numbers are the
upper readings the limits were set below (``PERF.md``).

    python3 benchmark/control.py --workload NAME --seeds N [N ...] [--calls C]

``--calls``: the calls of a run's schedule to compare (default: the
traffic's ``control_calls``, else 200).  One JSON line a seed, then one
with the smallest control reading of each number.  Not run by the
benchmark's runs.  Needs a card; ``--device cpu`` for a small test.
"""
import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
for _p in (ROOT, BENCH / "reference", BENCH):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

from harness import cell  # noqa: E402


def readings(workload: str, seeds, calls=None, device=None, bench_root: Path = ROOT):
    import numpy as np
    import torch
    sp = cell.spec(bench_root)
    work = cell.workload(sp, workload)
    cfg = cell.config(sp, work["config"], bench_root)
    traffic = cell.traffic(work["traffic"])
    if device is None:
        if not torch.cuda.is_available():
            raise SystemExit("control.py: no CUDA card")
        device = torch.device("cuda", 0)
    n = int(calls or traffic.get("control_calls", 200))
    sysmod = cell.module("systems", cfg["system"])
    rows = []
    for seed in seeds:
        t = time.perf_counter()
        system = sysmod.System(cfg, traffic, seed, device, lambda name: contextlib.nullcontext(),
                               program=False)
        ref = system.reference(tf32=False)
        ctl = system.reference(tf32=True)
        fake = system.as_calls(ctl, system.schedule(np.random.default_rng([seed, 2])), n)
        v = system.check(fake, reference=ref)
        rows.append({"workload": workload, "seed": seed, "correct": v["correct"],
                     "compared": v["compared"], "numbers": v["numbers"],
                     "seconds": time.perf_counter() - t})
        del system
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--calls", type=int)
    ap.add_argument("--device")
    a = ap.parse_args(argv)
    import torch
    rows = readings(a.workload, a.seeds, a.calls,
                    torch.device(a.device) if a.device else None)
    for r in rows:
        print(json.dumps(r))
    least = {k: min(r["numbers"][k]["value"] for r in rows) for k in rows[0]["numbers"]}
    print(json.dumps({"workload": a.workload, "least_control_reading": least,
                      "all_not_correct": not any(r["correct"] for r in rows)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
