"""Profiling hooks: ``torch.profiler`` traces, stage wall timing and CUDA-event
latency (JAX ``utils/profiling.py``), and the card measurements that
``chip_smoke.py`` and ``bench_torch.py`` share.

``device_trace`` writes a Chrome trace of a block; ``StageTimer`` splits a
run's wall time into named stages, each fenced by ``torch.cuda.synchronize``
on a CUDA device so that a stage owns the device work it enqueued;
``profile_callable`` times a callable on the card with CUDA events.  The
kernels' build directory ``vistaf_torch/_build`` plays the part of the JAX
package's persistent compilation cache.

The card measurements: ``event_times`` (each call between two CUDA events,
``torch.cuda.synchronize`` after the second), ``cuda_ms`` (their median),
``round_stats`` (rounds of such calls: the median of the round medians, a
tail percentile and the rounds' spread), ``host_syncs`` (the syncs one call
makes, from PyTorch's sync debug mode), ``device_ms`` (the kernels' and
copies' own time under ``torch.profiler``), ``d2h_copies`` (the
device-to-host copies one call makes) and ``profile_window`` (device busy
share, launches and the heaviest device work over a few calls).  Each needs
a card: a CPU run gives no device time.  Every trace is announced to
``cuda_graph.note_profiler`` first, which keeps the WHILE graphs that go
after it.
"""
from __future__ import annotations

import contextlib
import functools
import json
import os
import re
import tempfile
import time
import warnings
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from vistaf_torch.utils import cuda_graph


@contextlib.contextmanager
def device_trace(log_dir: str):
    """``torch.profiler`` trace of the block (host, and the card's kernels
    and copies where there is one), written to ``log_dir/trace.json``
    (Chrome trace format: chrome://tracing or Perfetto)."""
    from torch.profiler import ProfilerActivity, profile
    cuda_graph.note_profiler()

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
    lat = event_times(lambda: fn(*args), iters, warmup)
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn(*args)
    b.record()
    torch.cuda.synchronize()
    thr = iters / (a.elapsed_time(b) / 1000.0)
    return float(np.percentile(lat, 50)), float(np.mean(lat)), float(thr)


def event_times(fn, calls: int, warmup: int = 0) -> List[float]:
    """Milliseconds of each of ``calls`` calls of fn() after ``warmup``
    untimed ones: a CUDA event before and after the call, and
    ``torch.cuda.synchronize`` after the second, so that a call owns the
    device work it enqueued."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(calls):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return times


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median milliseconds of fn() over ``reps`` runs, CUDA events."""
    return float(np.median(event_times(fn, reps, warmup)))


def percentiles(times: Sequence[float], qs: Sequence[float] = (50, 90)) -> List[float]:
    """The percentiles ``qs`` of ``times`` (numpy's linear interpolation)."""
    return [float(v) for v in np.percentile(np.asarray(times, np.float64), qs)]


def tail_percentile(n: int) -> Optional[int]:
    """The tail percentile that ``n`` samples can show: 90 from 100 samples
    on, else the highest whole percentile with at least ten samples beyond
    it (floor(100 * (n - 10) / n)); None below 11 samples."""
    if n >= 100:
        return 90
    if n <= 10:
        return None
    return (100 * (n - 10)) // n


def round_stats(rounds: Sequence[Sequence[float]]) -> Dict[str, object]:
    """Statistics of R rounds of N timed calls (milliseconds): ``p50_ms``,
    the median of the round medians; ``tail`` and ``tail_ms``, the
    percentile of ``tail_percentile`` over all samples, and its name
    ("p90", "p66", ..., None); ``round_medians_ms`` and their spread
    (``spread_ms``, max - min, and ``spread_share``, over p50);
    ``samples``."""
    medians = [float(np.median(r)) for r in rounds]
    flat = [float(t) for r in rounds for t in r]
    p50 = float(np.median(medians))
    q = tail_percentile(len(flat))
    spread = max(medians) - min(medians)
    return {"p50_ms": p50, "tail": None if q is None else f"p{q}",
            "tail_ms": None if q is None else percentiles(flat, (q,))[0],
            "round_medians_ms": medians, "spread_ms": spread,
            "spread_share": spread / p50 if p50 > 0 else None, "samples": len(flat)}


def host_syncs(fn) -> int:
    """The host syncs one call of fn() makes, as PyTorch's sync debug mode
    reports them (a lower bound: it sees the syncs of PyTorch's own ops)."""
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    return sum("synchroniz" in str(w.message) for w in caught)


def device_ms(fn, reps: int = 10) -> float:
    """Milliseconds of kernel and copy time on the card per call of fn()
    (``torch.profiler``, device-side events), without the host's enqueue:
    beside ``cuda_ms`` it tells a kernel bound by its launches from one
    bound by the card."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    cuda_graph.note_profiler()
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e3 / reps


def _d2h_bytes(prof) -> List[int]:
    """The bytes of each device-to-host copy in a profile (its Chrome
    trace's ``gpu_memcpy`` events)."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return [int(e["args"]["bytes"]) for e in events
            if e.get("cat") == "gpu_memcpy" and "DtoH" in e.get("name", "")]


def d2h_copies(fn):
    """(count, bytes) of the device-to-host copies one call of fn() makes,
    from torch.profiler's memcpy events (the trace's ``bytes``)."""
    from torch.profiler import ProfilerActivity, profile
    cuda_graph.note_profiler()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    copies = _d2h_bytes(prof)
    return len(copies), copies


@functools.lru_cache(maxsize=None)
def _kernel_names() -> frozenset:
    """The hand-written kernels' names: every ``__global__`` function of
    ``csrc/*.cu``."""
    from vistaf_torch.kernels import CSRC_DIR
    pat = re.compile(r"__global__\s+void\s+(?:__\w+__\([^)]*\)\s*)*(\w+)\s*\(")
    return frozenset(n for p in CSRC_DIR.glob("*.cu") for n in pat.findall(p.read_text()))


def _hand_written(key: str) -> Optional[str]:
    """The kernel's name, template arguments and all, where a profiler key
    is one of ``csrc/*.cu``'s kernels (each in a top-level anonymous
    namespace; a template's key starts with its return type, ``void``),
    else None: PyTorch keeps kernels in such a namespace too."""
    if key.startswith("void "):
        key = key[5:]
    if not key.startswith("(anonymous namespace)::"):
        return None
    name = key.split("::", 1)[1].split("(")[0]
    return name if name.split("<")[0] in _kernel_names() else None


def profile_window(fn, frames: int, copies: bool = False) -> Dict[str, object]:
    """Device busy share of a steady window of ``frames`` calls of fn()
    (one untimed call first): the kernels' self device time
    (``torch.profiler``) over the window's wall time, profiler on; the
    launches (``cudaLaunchKernel``, the cooperative and cluster launches and
    the CUDA graph replays, ``cudaGraphLaunch``, apart), the ten heaviest
    device entries and the hand-written kernels (``csrc/*.cu`` keeps each in
    an anonymous namespace), each per call; with ``copies`` also the device-to-host copies and their bytes
    per call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    cuda_graph.note_profiler()
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(frames):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / frames
    averages = prof.key_averages()
    # device-side events only (kernels, copies): host ops report their
    # kernels' time too and would count it twice
    events = [e for e in averages
              if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3 / frames
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:10]
    launches = sum(e.count for e in averages if e.key == "cudaLaunchKernel")
    special = sum(e.count for e in averages
                  if e.key in ("cudaLaunchCooperativeKernel", "cudaLaunchKernelExC"))
    graphs = sum(e.count for e in averages if e.key == "cudaGraphLaunch")
    ours = [[name, e.self_device_time_total / 1e3 / frames, e.count / frames]
            for e in events if (name := _hand_written(e.key))]
    out = dict(frames=frames, wall_ms_per_frame=wall_ms, device_busy_ms_per_frame=busy_ms,
               device_busy_share=busy_ms / wall_ms,
               cuda_launches_per_frame=launches / frames,
               cooperative_or_cluster_launches_per_frame=special / frames,
               graph_launches_per_frame=graphs / frames,
               top=[[e.key[:60], e.self_device_time_total / 1e3 / frames, e.count / frames]
                    for e in top],
               hand_written=ours)
    if copies:
        nbytes = _d2h_bytes(prof)
        out.update(d2h_copies_per_frame=len(nbytes) / frames,
                   d2h_bytes_per_frame=sum(nbytes) / frames)
    return out
