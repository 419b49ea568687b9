"""Profiling hooks: the port's span-and-counter recorder, ``torch.profiler``
traces, and the card measurements that ``chip_smoke.py`` and
``bench_torch.py`` share.

The recorder (``span``, ``on_device``, ``spans``, ``spans_reset``) is on
exactly while a ``torch.profiler`` trace is collecting; off, ``span(name)``
is one flag test and returns a shared null context.  On, each span is a
``record_function`` range named ``vistaf.<name>``, so it shows in the
Chrome trace on the clock of the card's kernels and copies, and a record
in a bounded buffer: its name, start and end (``time.perf_counter_ns``),
its parent and the id of the entry call that every span of one call
shares.  ``on_device`` wraps a CUDA graph's replay inside a ``replay``
span: a CUDA event on the replay's stream before and after it, put on the
host clock through one anchor a device (a synchronize, then host readings
around a few events, taken at the first replay the recorder sees), and the
condition setter's slots (``graph_cond_kernel.SITES``) copied to pinned
memory before and after it, which give the replay's WHILE trips and IF
runs by site.  Both are read when the call's outermost span closes, once
the card has done them (the call's fetch has synchronized), or when a
reader asks: the recorder adds no synchronize to a call but the anchor's.

``device_trace`` writes a Chrome trace of a block.  The kernels' build
directory ``vistaf_torch/_build`` plays the part of the JAX package's
persistent compilation cache.

The card measurements: ``event_times`` (each call between two CUDA events,
``torch.cuda.synchronize`` after the second), ``cuda_ms`` (their median),
``round_stats`` (rounds of such calls: the median of the round medians, a
tail percentile and the rounds' spread), ``host_syncs`` (the syncs one call
makes, from PyTorch's sync debug mode), ``device_ms`` (the kernels' and
copies' own time under ``torch.profiler``), ``d2h_copies`` (the
device-to-host copies one call makes) and ``profile_window`` (device busy
share, launches and the heaviest device work over a few calls).  Each needs
a card: a CPU run gives no device time; each keeps the recorder off, so
that it counts the program's work and not the recorder's.  Every trace is announced to
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
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.autograd.profiler as _autograd_profiler

# the recorder's switch: ``_is_profiler_enabled`` holds while a
# torch.profiler trace is collecting (``_forced`` swaps it)
_switch = _autograd_profiler
_NULL = contextlib.nullcontext()
MAX_SPANS = 1 << 16
ANCHOR_EVENTS = 32


@dataclass
class Span:
    """One recorded span.  ``device_ns``: a replay's (start, end) on the
    card, on the host's ``perf_counter_ns`` clock; ``trips``: the condition
    setter's runs during it by site (a WHILE site's trips, an IF site's
    runs, ``entry`` the WHILE nodes' first sets).  Both None until read,
    and on any span but a replay."""
    name: str
    start_ns: int
    end_ns: int
    parent: int        # index in ``spans()``; -1 for a call's outermost span
    call: int          # shared by every span of one entry call
    device_ns: Optional[Tuple[int, int]] = None
    trips: Optional[Dict[str, int]] = None


@dataclass
class _Replay:
    span: Span
    device: torch.device
    begin: torch.cuda.Event
    end: torch.cuda.Event
    done: torch.cuda.Event     # after the second slot copy
    slots: torch.Tensor        # (2, sites) pinned: before and after

    def read(self, anchors) -> None:
        from vistaf_torch.kernels.graph_cond_kernel import SITES
        host_ns, ev = anchors[self.device.index]
        self.span.device_ns = (host_ns + round(ev.elapsed_time(self.begin) * 1e6),
                               host_ns + round(ev.elapsed_time(self.end) * 1e6))
        before, after = self.slots.tolist()
        self.span.trips = {k: b - a for k, a, b in zip(SITES, before, after)}


class _Recorder:
    def __init__(self):
        self.records: List[Span] = []
        self.dropped = 0
        self.calls = 0
        self.stack: List[int] = []          # indices of the open spans
        self.anchors: Dict[int, Tuple[int, torch.cuda.Event]] = {}
        self.anchor_width_ns: Dict[int, int] = {}
        self.pending: List[_Replay] = []

    def anchor(self, device: torch.device) -> None:
        """The device's anchor: the host time of a first event on the card.
        Each of ANCHOR_EVENTS events, recorded on an idle card, ran after
        its record was called and before its synchronize returned; less its
        time after the first event, each bounds the first's host time from
        both sides, and the middle of the tightest bounds is taken
        (``anchor_width_ns``: their distance)."""
        if device.index in self.anchors:
            return
        stream = torch.cuda.current_stream(device)
        torch.cuda.synchronize(device)
        taken = []
        for _ in range(ANCHOR_EVENTS):
            ev = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter_ns()
            ev.record(stream)
            ev.synchronize()
            taken.append((t0, time.perf_counter_ns(), ev))
        first = taken[0][2]
        after = [round(first.elapsed_time(ev) * 1e6) for _, _, ev in taken]
        lo = max(t0 - d for (t0, _, _), d in zip(taken, after))
        hi = min(t1 - d for (_, t1, _), d in zip(taken, after))
        self.anchors[device.index] = ((lo + hi) // 2, first)
        self.anchor_width_ns[device.index] = hi - lo

    def resolve(self, wait: bool) -> None:
        """Read the replays the card has done (all of them with ``wait``)."""
        left = []
        for r in self.pending:
            if wait:
                r.done.synchronize()
            if wait or r.done.query():
                r.read(self.anchors)
            else:
                left.append(r)
        self.pending = left


_REC = _Recorder()


class _Open:
    """A span being recorded: the ``record_function`` range and the record."""
    __slots__ = ("name", "fn", "index")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> Optional[Span]:
        self.fn = _autograd_profiler.record_function("vistaf." + self.name)
        self.fn.__enter__()
        rec, t = _REC, time.perf_counter_ns()
        stack = rec.stack
        if len(rec.records) >= MAX_SPANS:
            rec.dropped += 1
            self.index = -1
            return None
        parent = stack[-1] if stack else -1
        if parent >= 0:
            call = rec.records[parent].call
        else:
            rec.calls += 1
            call = rec.calls
        self.index = len(rec.records)
        rec.records.append(Span(self.name, t, 0, parent, call))
        stack.append(self.index)
        return rec.records[-1]

    def __exit__(self, *exc):
        rec = _REC
        if self.index >= 0:
            rec.records[self.index].end_ns = time.perf_counter_ns()
            rec.stack.pop()
            if not rec.stack and rec.pending:
                rec.resolve(wait=False)
        self.fn.__exit__(*exc)
        return False


def span(name: str):
    """``with span(name):`` records the block as ``vistaf.<name>`` while a
    ``torch.profiler`` trace is collecting; else a shared null context.
    The ``as`` target is the record (None when off)."""
    if not _switch._is_profiler_enabled:
        return _NULL
    return _Open(name)


@contextlib.contextmanager
def _device_span(sp: Span, device: torch.device):
    from vistaf_torch.kernels import graph_cond_kernel
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    rec = _REC
    rec.anchor(device)
    stream = torch.cuda.current_stream(device)
    slots = torch.empty((2, len(graph_cond_kernel.SITES)), dtype=torch.int64,
                        pin_memory=True)
    begin, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    done = torch.cuda.Event()
    graph_cond_kernel.slots_async(slots[0], device)
    begin.record(stream)
    yield
    end.record(stream)
    # after the end event, so that a copy queued behind another on the card
    # does not stretch the span
    graph_cond_kernel.slots_async(slots[1], device)
    done.record(stream)
    rec.pending.append(_Replay(sp, device, begin, end, done, slots))


def on_device(sp: Optional[Span], device: torch.device):
    """Around a CUDA graph's replay on ``device``'s current stream, inside
    the span ``sp``: its device start and end and the setter's runs by site
    (``Span.device_ns``, ``Span.trips``).  A null context when ``sp`` is
    None (the recorder off)."""
    if sp is None:
        return _NULL
    return _device_span(sp, device)


def spans() -> List[Span]:
    """The recorded spans, oldest first (``parent`` indexes this list); the
    replays' device spans and trips read first, waiting for the card."""
    _REC.resolve(wait=True)
    return list(_REC.records)


def spans_reset() -> None:
    """Empty the buffer (after reading the replays still pending) and drop
    the anchors: the next replay the recorder sees takes a new one."""
    _REC.resolve(wait=True)
    _REC.records.clear()
    _REC.dropped = 0
    _REC.anchors.clear()
    _REC.anchor_width_ns.clear()


@contextlib.contextmanager
def _forced(on: bool):
    """The recorder on (or off) whatever the profiler does: its cost
    measured without a trace, tests, and the measurements below, which
    count the program's own copies and launches under a trace."""
    global _switch
    saved = _switch
    _switch = type("_Switch", (), {"_is_profiler_enabled": on})
    try:
        yield
    finally:
        _switch = saved


def _note_profiler() -> None:
    from vistaf_torch.utils import cuda_graph
    cuda_graph.note_profiler()


@contextlib.contextmanager
def device_trace(log_dir: str):
    """``torch.profiler`` trace of the block (host, and the card's kernels
    and copies where there is one), written to ``log_dir/trace.json``
    (Chrome trace format: chrome://tracing or Perfetto).  The recorder's
    spans are in it as ``vistaf.*`` ranges."""
    from torch.profiler import ProfilerActivity, profile
    _note_profiler()

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


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
    _note_profiler()
    fn()
    torch.cuda.synchronize()
    with _forced(False), \
            profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e3 / reps


def _trace_events(prof) -> List[dict]:
    """The events of a profile's Chrome trace."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]
    finally:
        os.unlink(path)


def _d2h_bytes(events: List[dict]) -> List[int]:
    """The bytes of each device-to-host copy among a Chrome trace's events
    (its ``gpu_memcpy`` events)."""
    return [int(e["args"]["bytes"]) for e in events
            if e.get("cat") == "gpu_memcpy" and "DtoH" in e.get("name", "")]


def _device_busy_us(events: List[dict]) -> float:
    """Microseconds in which some kernel, copy or memset ran on the card:
    the union of their intervals over all streams, so that overlapping work
    counts once."""
    total, end = 0.0, float("-inf")
    for a, b in sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
                       if e.get("ph") == "X" and "dur" in e
                       and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def d2h_copies(fn):
    """(count, bytes) of the device-to-host copies one call of fn() makes,
    from torch.profiler's memcpy events (the trace's ``bytes``)."""
    from torch.profiler import ProfilerActivity, profile
    _note_profiler()
    torch.cuda.synchronize()
    with _forced(False), \
            profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    copies = _d2h_bytes(_trace_events(prof))
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
    (one untimed call first): the union of the kernels', copies' and
    memsets' intervals (``torch.profiler``'s Chrome trace, so that work
    overlapping on two streams counts once) over the window's wall time,
    profiler on; the
    launches (``cudaLaunchKernel``, the cooperative and cluster launches and
    the CUDA graph replays, ``cudaGraphLaunch``, apart), the ten heaviest
    device entries and the hand-written kernels (``csrc/*.cu`` keeps each in
    an anonymous namespace), each per call; with ``copies`` also the
    device-to-host copies and their bytes per call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    _note_profiler()
    fn()
    torch.cuda.synchronize()
    with _forced(False), \
            profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
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
    trace = _trace_events(prof)
    busy_ms = _device_busy_us(trace) / 1e3 / frames
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
        nbytes = _d2h_bytes(trace)
        out.update(d2h_copies_per_frame=len(nbytes) / frames,
                   d2h_bytes_per_frame=sum(nbytes) / frames)
    return out
