"""Whether destroying a CUDA graph that holds WHILE nodes is safe, with and
without ``torch.profiler`` in the process, on one GPU.

    python3 scripts/torch_graph_lifetime.py [--modes never after after_no_teardown]

Each mode runs in a fresh process of its own, so that a fault in one ends
only that one.  Every mode keeps one graph alive (``A``: the 640x480 parity
force forward, ``scaled_ftp_config(480, 640)``, whose ECC and PCG loops are
WHILE nodes), then three times captures a second pipeline's graph (``B``),
replays it against its eager forward (bit for bit) and destroys it:
``vistaf_torch.utils.cuda_graph`` keeps such graphs once a profiler has
traced the card (``_RETAINED``), so the mode empties that list too.  Then
it replays ``A`` under the profiler (``profiling.profile_window``, twice)
and bit for bit against its eager run.

- ``never``: no profiler runs before the destroys.
- ``after``: one profiled replay of ``A`` comes first.
- ``after_no_teardown``: as ``after``, with ``TEARDOWN_CUPTI=0`` in the
  environment (PyTorch's own setting for CUPTI in a process with CUDA
  graphs, ``torch/profiler/profiler.py``), so the profiler keeps CUPTI set
  up between sessions.

Each child prints one JSON line a step (``mode``, ``step``, whether the
CUPTI library is mapped into the process yet, the memory PyTorch
reserves); the parent prints them, then one line a mode with the child's
exit code (-11: a segfault), then ``{"ok": ..., "failed_modes": [...]}``,
true when every mode ended with code 0.  Exits 1 when a mode did not.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
MODES = ("never", "after", "after_no_teardown")


def cupti_loaded() -> bool:
    """Whether the CUPTI library is mapped into this process."""
    with open("/proc/self/maps") as f:
        return "libcupti" in f.read()


def say(mode: str, step: str, **kw) -> None:
    import torch
    print(json.dumps({"mode": mode, "step": step, "cupti_loaded": cupti_loaded(),
                      "reserved_gib": torch.cuda.memory_reserved() / 2 ** 30, **kw}),
          flush=True)


def child(mode: str) -> None:
    import torch
    import chip_smoke as cs
    from vistaf_torch import use_full_fp32
    from vistaf_torch.ftp.pipeline import FTPPipeline
    from vistaf_torch.utils import cuda_graph, profiling
    from vistaf_torch.utils.synthetic import scaled_ftp_config, synthetic_pair

    if mode == "after_no_teardown":
        os.environ["TEARDOWN_CUPTI"] = "0"
    use_full_fp32()
    say(mode, "imported")
    cfg = scaled_ftp_config(480, 640)
    ref, de = (torch.as_tensor(f, device="cuda")
               for f in synthetic_pair(480, 640, cfg, seed=cs.SEED, dent_depth_rad=0.8))

    def replayed(pipe):
        pipe.forward(ref, de)                       # eager, then the capture
        got, want = pipe.forward(ref, de), pipe.forward_eager(ref, de)
        cs.same_outputs("forward", got, want)
        return got

    a = FTPPipeline(cfg, cs.P2H_MODEL, device="cuda")
    replayed(a)
    say(mode, "A captured", whiles=cuda_graph._WHILE_NODES[0],
        retained=len(cuda_graph._RETAINED))
    if mode != "never":
        profiling.profile_window(lambda: a.forward(ref, de), 1)
        say(mode, "A profiled")
    for k in range(3):
        b = FTPPipeline(cfg, cs.P2H_MODEL, device="cuda")
        replayed(b)
        del b
        cuda_graph._RETAINED.clear()
        gc.collect()
        torch.cuda.synchronize()
        say(mode, f"B{k} destroyed")
    torch.cuda.empty_cache()
    say(mode, "emptied")
    for k in range(2):
        profiling.profile_window(lambda: a.forward(ref, de), 2)
        say(mode, f"A profiled after the destroys ({k})")
    cs.same_outputs("A", a.forward(ref, de), a.forward_eager(ref, de))
    say(mode, "done")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--modes", nargs="+", choices=MODES, default=list(MODES))
    ap.add_argument("--child", choices=MODES, help=argparse.SUPPRESS)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_graph_lifetime: CUDA is not available", file=sys.stderr)
        return 1
    if args.child:
        child(args.child)
        return 0
    from vistaf_torch import kernels
    kernels.build()
    failed = []
    for mode in args.modes:
        p = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", mode],
                           capture_output=True, text=True, timeout=600)
        steps = [line for line in p.stdout.splitlines() if line.startswith("{")]
        for line in steps:
            print(line, flush=True)
        print(json.dumps({"mode": mode, "returncode": p.returncode, "steps": len(steps),
                          "stderr_tail": p.stderr[-600:]}), flush=True)
        if p.returncode != 0:
            failed.append(mode)
    print(json.dumps({"ok": not failed, "failed_modes": failed}))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
