"""Closed loop: one controller that hands the entry its next inputs (a
frame, a stream batch, or a sequence of batches dispatched ahead) as soon
as the previous call's results are on the host.  Each call is
timed on the host clock from the hand-over of its inputs to its results on
the host; the window runs from the loop's start to the end of the last call
that started within the window's seconds.  With ``spans`` the loop marks
its own host spans for the profiler (``bench.window``, ``bench.traffic``,
``bench.call``, ``bench.record``); the untraced run marks nothing."""
from __future__ import annotations

import contextlib
import gc
import time
from typing import Iterable

from harness.window import Call, Window


def _span(on: bool):
    if on:
        from torch.profiler import record_function
        return record_function
    return lambda name: contextlib.nullcontext()


def warm(system, clock) -> None:
    """The cell's own inputs through the entry before the window: the first
    call captures the graph (``capture``), the rest replay it (``warmup``);
    then the system is settled back to its starting state."""
    import torch
    for k, x in enumerate(system.warm_inputs()):
        with clock("capture" if k == 0 else "warmup"):
            system.entry(x)
            if torch.device(system.device).type == "cuda":
                torch.cuda.synchronize()
    system.settle()


def run(system, seconds: float, schedule: Iterable, spans: bool = False) -> Window:
    span = _span(spans)
    sched = iter(schedule)
    win = Window()
    # the set-up's objects out of the collector's way: a collection in the
    # window then walks only what the window made
    gc.collect()
    gc.freeze()
    with span("bench.window"):
        win.start = t1 = time.perf_counter()
        stop = win.start + seconds
        while t1 < stop:
            with span("bench.traffic"):
                x = next(sched)
            t0 = time.perf_counter()
            with span("bench.call"):
                out = system.entry(x)
            t1 = time.perf_counter()
            with span("bench.record"):
                win.calls.append(Call(t0, t1, system.frames_per_call, x, out))
        win.end = t1
    return win
