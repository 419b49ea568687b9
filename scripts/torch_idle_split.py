"""One run of a benchmark cell (``benchmark/run.py``) with the program's
spans read apart: where the card's idle time goes, and what the recorder
costs.

    python3 scripts/torch_idle_split.py --workload NAME --seed N --seconds S \\
        --trace 0|1 [--recorder on|off]

From the root of a checkout, on the card.  The run is ``benchmark/run.py``'s
own, with its lines; ``--recorder on`` forces the span recorder on for the
whole run (``profiling._forced``), so an untraced run with it on against
one with it off gives its cost.  After a traced run one more JSON line,
``split``: the idle card time in milliseconds a frame inside the ingest,
fetch and launch spans, inside any other program span and outside every
one, and their ``total``; ``device_idle_ms`` (the same from
``device_idle_pct``); the clock mapping (``offset_us``, ``residual_us``);
``calls_outside`` (program calls not inside their ``bench.call`` span, and
the largest excess, us); ``replay_kernel_us`` (each replay's device span
against the kernels of its graph launch, ``progspans.replay_kernel_gaps``:
the least and most of each of its three gaps); ``anchor_width_us`` (how
closely the recorder placed the card's clock on the host's); ``trips``
(the setter's runs a frame by site); ``named_gaps`` (the longest idle
stretches, each named by the program span and the runtime call the host
was in).
"""
import argparse
import contextlib
import importlib.util
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--recorder", choices=("on", "off"), default="off")
    args, rest = ap.parse_known_args(argv)
    spec = importlib.util.spec_from_file_location("bench_run", ROOT / "benchmark" / "run.py")
    run = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(run)
    from harness import cell, progspans
    seen = {}
    idle = cell.module("metrics", "device_idle_pct")
    read = idle.read

    def keep(ctx):
        seen["ctx"] = ctx
        return read(ctx)
    idle.read = keep
    from vistaf_torch.utils import profiling
    with profiling._forced(True) if args.recorder == "on" else contextlib.nullcontext():
        rc = run.run(rest)
    ctx = seen.get("ctx")
    if rc != 0 or ctx is None or ctx.trace is None:
        return rc
    split = progspans.idle_split(ctx)
    clk = progspans.clock(ctx)
    gaps = progspans.replay_kernel_gaps(ctx) or []
    trips = {}
    for s in progspans.replays(ctx):
        for k, v in (s.trips or {}).items():
            trips[k] = trips.get(k, 0) + v
    pct = read(ctx)
    print(json.dumps({"split": split,
                      "device_idle_ms": None if pct is None
                      else pct / 100 * ctx.trace.window_us / 1e3 / ctx.frames,
                      "offset_us": clk and clk[0], "residual_us": clk and clk[1],
                      "calls_outside": progspans.calls_outside(ctx),
                      "replays": len(progspans.replays(ctx)),
                      "replay_kernel_us": [[min(g[k] for g in gaps), max(g[k] for g in gaps)]
                                           for k in range(3)] if gaps else None,
                      "anchor_width_us": {k: v / 1e3 for k, v in
                                          profiling._REC.anchor_width_ns.items()},
                      "trips": {k: v / ctx.frames for k, v in trips.items()},
                      "named_gaps": progspans.named_gaps(ctx)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
