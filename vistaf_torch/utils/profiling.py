"""Profiling hooks: ``torch.profiler`` traces, stage wall timing and CUDA-event
latency (JAX ``utils/profiling.py``).

``device_trace`` writes a Chrome trace of a block; ``StageTimer`` splits a
run's wall time into named stages, each fenced by ``torch.cuda.synchronize``
on a CUDA device so that a stage owns the device work it enqueued;
``profile_callable`` times a callable on the card with CUDA events.  The
kernels' build directory ``vistaf_torch/_build`` plays the part of the JAX
package's persistent compilation cache.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Dict

import numpy as np
import torch


@contextlib.contextmanager
def device_trace(log_dir: str):
    """``torch.profiler`` trace of the block (host, and the card's kernels
    and copies where there is one), written to ``log_dir/trace.json``
    (Chrome trace format: chrome://tracing or Perfetto)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class StageTimer:
    """Accumulating wall-clock stage timer.  On a CUDA ``device`` each stage
    starts and ends with ``torch.cuda.synchronize``."""

    def __init__(self, device="cpu"):
        self.sync = torch.device(device).type == "cuda"
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        if self.sync:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.sync:
                torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        lines = []
        for name, total in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            n = self.counts[name]
            lines.append(f"{name:30s} {total * 1000:9.2f} ms total  "
                         f"{total / n * 1000:8.2f} ms/call  x{n}")
        return "\n".join(lines)


def profile_callable(fn, *args, iters: int = 20, warmup: int = 1):
    """(p50_ms, mean_ms, throughput_per_s) of ``fn(*args)`` on the card:
    each call's latency between two CUDA events, then ``iters`` calls back
    to back between two more.  Raises without a card: a CPU run gives no
    device time."""
    if not torch.cuda.is_available():
        raise RuntimeError("profile_callable times the card with CUDA events; "
                           "CUDA is not available")
    for _ in range(warmup):
        fn(*args)
    torch.cuda.synchronize()
    lat = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn(*args)
        b.record()
        torch.cuda.synchronize()
        lat.append(a.elapsed_time(b))
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn(*args)
    b.record()
    torch.cuda.synchronize()
    thr = iters / (a.elapsed_time(b) / 1000.0)
    return float(np.percentile(lat, 50)), float(np.mean(lat)), float(thr)
