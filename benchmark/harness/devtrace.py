"""Reduction of a ``torch.profiler`` Chrome trace of the measured window.

Device activity is every kernel, copy and memset on the card
(``cat`` ``kernel``, ``gpu_memcpy``, ``gpu_memset``); the busy time is the
union of their intervals over all streams, so work that overlaps (a copy on
a side stream under a kernel) counts once.  Host spans are the benchmark's
own ``record_function`` ranges (``user_annotation``: ``bench.window``,
``bench.call``, ``bench.traffic``, ``bench.record``); runtime calls are the
``cuda_runtime`` and ``cuda_driver`` events.  Times are the trace's
microseconds, one clock for host and device.
"""
from __future__ import annotations

import bisect
import json
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")
# runtime calls in which the host waits for the card
WAIT_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
              "cuStreamSynchronize", "cuCtxSynchronize", "cuEventSynchronize")
COPY_CALLS = ("cudaMemcpy", "cudaMemcpyAsync", "cuMemcpyDtoH_v2", "cuMemcpyDtoHAsync_v2")

Interval = Tuple[float, float]


@dataclass
class Trace:
    """The events of one traced window, split by kind and clipped to the
    ``bench.window`` span."""
    window: Interval
    device: List[dict]
    runtime: List[dict]
    spans: List[dict]

    @property
    def window_us(self) -> float:
        return self.window[1] - self.window[0]


def load(path: str) -> Trace:
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return from_events(events)


def from_events(events: Iterable[dict]) -> Trace:
    """Sort a trace's complete events ('X') into device work, runtime calls
    and the benchmark's spans, keeping those inside ``bench.window``."""
    device, runtime, spans = [], [], []
    win = None
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat, name = e.get("cat", ""), e.get("name", "")
        if cat == "user_annotation" and name.startswith("bench."):
            if name == "bench.window":
                win = (float(e["ts"]), float(e["ts"]) + float(e["dur"]))
            else:
                spans.append(e)
        elif cat in DEVICE_CATS:
            device.append(e)
        elif cat in RUNTIME_CATS:
            runtime.append(e)
    if win is None:
        raise ValueError("the trace has no bench.window span")

    def inside(e):
        return float(e["ts"]) < win[1] and float(e["ts"]) + float(e["dur"]) > win[0]
    return Trace(win, [e for e in device if inside(e)], [e for e in runtime if inside(e)],
                 [e for e in spans if inside(e)])


def interval(e: dict) -> Interval:
    return float(e["ts"]), float(e["ts"]) + float(e["dur"])


def union(intervals: Iterable[Interval], clip: Optional[Interval] = None) -> List[Interval]:
    """The union of intervals as sorted disjoint intervals, within ``clip``."""
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if clip is not None:
            a, b = max(a, clip[0]), min(b, clip[1])
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def busy_us(tr: Trace) -> float:
    """Microseconds of the window in which some operation ran on the card."""
    return sum(b - a for a, b in union((interval(e) for e in tr.device), tr.window))


def gaps(tr: Trace) -> List[Interval]:
    """The window's stretches with nothing on the card."""
    busy = union((interval(e) for e in tr.device), tr.window)
    out, t = [], tr.window[0]
    for a, b in busy:
        if a > t:
            out.append((t, a))
        t = b
    if tr.window[1] > t:
        out.append((t, tr.window[1]))
    return out


def spans(tr: Trace, name: str) -> List[dict]:
    return [e for e in tr.spans if e["name"] == name]


def covered_us(outer: Interval, inner: Sequence[Interval]) -> float:
    """Microseconds of ``outer`` that the union of ``inner`` covers."""
    return sum(b - a for a, b in union(inner, outer))


def correlation(e: dict) -> Optional[int]:
    return (e.get("args") or {}).get("correlation")


def waits(tr: Trace) -> List[Interval]:
    """The runtime calls in which the host waited for the card: the
    synchronizations, and the copies whose device side is a copy to the
    host (such a copy first waits for the work queued before it)."""
    d2h = {correlation(e) for e in tr.device
           if e.get("cat") == "gpu_memcpy" and "DtoH" in e.get("name", "")}
    return [interval(e) for e in tr.runtime
            if e["name"] in WAIT_CALLS or (e["name"] in COPY_CALLS and correlation(e) in d2h)]


def named_at(tr: Trace, t: float) -> str:
    """What the host was doing at trace time ``t``: the innermost of the
    benchmark's spans that holds it, and the runtime call in progress, if
    any (``call/cudaStreamSynchronize``; ``python`` for none)."""
    span = "window"
    best = None
    for e in tr.spans:
        a, b = interval(e)
        if a <= t < b and (best is None or b - a < best):
            best, span = b - a, e["name"][len("bench."):]
    call = "python"
    for e in tr.runtime:
        a, b = interval(e)
        if a <= t < b:
            call = e["name"]
            break
    return f"{span}/{call}"


def top_device_ops(tr: Trace, n: int = 10) -> List[List]:
    """The ``n`` device operations that took most time in the window,
    summed by name: [[name, seconds], ...]."""
    total: Dict[str, float] = {}
    for e in tr.device:
        a, b = interval(e)
        a, b = max(a, tr.window[0]), min(b, tr.window[1])
        if b > a:
            total[e["name"]] = total.get(e["name"], 0.0) + (b - a)
    top = sorted(total.items(), key=lambda kv: -kv[1])[:n]
    return [[name[:200], us * 1e-6] for name, us in top]


def longest_gaps(tr: Trace, n: int = 10) -> List[List]:
    """The ``n`` longest idle stretches, each named by what the host was
    doing at its middle: [[name, seconds], ...]."""
    top = sorted(gaps(tr), key=lambda g: -(g[1] - g[0]))[:n]
    return [[named_at(tr, (a + b) / 2), (b - a) * 1e-6] for a, b in top]
