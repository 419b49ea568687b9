"""The measured window's end-to-end statistics, from the calls' host
clock readings: the rate over the whole window and the tail of every call.
No statistic here is taken from medians of chunks."""
from __future__ import annotations

import statistics
from dataclasses import dataclass, field
from typing import Any, List, Optional, Sequence

import numpy as np


@dataclass
class Call:
    """One call of the entry: host clock at the hand-over of its inputs and
    at its results on the host (seconds, ``time.perf_counter``), the camera
    frames it completes, the scenes it was given and what it returned."""
    start: float
    end: float
    frames: int
    scenes: Any
    out: Any


@dataclass
class Window:
    """The calls of one measured window and its bounds: from the first
    call's start to the end of the last call, which started before the
    window's seconds had run out."""
    calls: List[Call] = field(default_factory=list)
    start: float = 0.0
    end: float = 0.0

    @property
    def seconds(self) -> float:
        return self.end - self.start

    @property
    def frames(self) -> int:
        return sum(c.frames for c in self.calls)


def frames_per_s(win: Window) -> Optional[float]:
    """Frames completed over the window, over the window's seconds."""
    if not win.calls or win.seconds <= 0:
        return None
    return win.frames / win.seconds


def latency_percentile_ms(win: Window, q: float = 95.0) -> Optional[float]:
    """The ``q``-th percentile (numpy's linear interpolation) of every
    call's latency, each frame weighted as its call (a frame of a step has
    its step's latency)."""
    if not win.calls:
        return None
    lat = np.repeat([(c.end - c.start) * 1e3 for c in win.calls],
                    [c.frames for c in win.calls])
    return float(np.percentile(lat, q))


def tail_percentile(n: int) -> Optional[int]:
    """The tail percentile that ``n`` samples can show: 90 from 100 samples
    on, else the highest whole percentile with at least ten samples beyond
    it; None below 11 samples (a frozen copy of
    ``vistaf_torch/utils/profiling.py::tail_percentile``)."""
    if n >= 100:
        return 90
    if n <= 10:
        return None
    return (100 * (n - 10)) // n


def spread(values: Sequence[float]) -> float:
    """The distance between the first and third quartiles
    (``statistics.quantiles(values, n=4)``) as a share of the median."""
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)
