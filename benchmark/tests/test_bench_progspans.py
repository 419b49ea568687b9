"""The program-span metrics (``harness/progspans.py``): the recorder's
clock mapped onto the trace's through the ``bench.call`` spans, idle time
put down to the program's spans on a synthetic device timeline, and every
new metric None where it has nothing to read."""
import os
import tempfile
from types import SimpleNamespace

import pytest

from harness import cell, devtrace, progspans
from harness.window import Call, Window

METRICS = ("ingest_ms_per_frame", "ingest_idle_ms_per_frame", "fetch_idle_ms_per_frame",
           "launch_idle_ms_per_frame", "replay_device_ms_per_frame", "ecc_trips_per_frame",
           "pcg_trips_per_frame")
OFFSET = 5000.0     # the trace's clock less the host's, microseconds


def _ev(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "args": args}


def _span(name, a_us, b_us, parent, call, **kw):
    """A record as the recorder keeps it, times in host microseconds."""
    return SimpleNamespace(name=name, start_ns=int(a_us * 1e3), end_ns=int(b_us * 1e3),
                           parent=parent, call=call, device_ns=kw.get("device_ns"),
                           trips=kw.get("trips"))


def _ctx():
    """Two calls of one frame, 200 us apart.  A call (host us from 1e6):
    the entry 20-80, ingest 20-30, replay 30-60 (device 34-56), fetch
    60-80; on the card one kernel 35-55 a call, launched at 32."""
    t0 = 1_000_000.0
    calls, spans, events = [], [], [_ev("user_annotation", "bench.window",
                                        t0 - 10 + OFFSET, 320)]
    for k in range(2):
        c = t0 + 200 * k
        calls.append(Call((c) / 1e6, (c + 100) / 1e6, 1, k, None))
        events.append(_ev("user_annotation", "bench.call", c + 10 + OFFSET, 80))
        root = len(spans)
        spans += [_span("step_fused", c + 20, c + 80, -1, k + 1),
                  _span("ingest", c + 20, c + 30, root, k + 1),
                  _span("replay", c + 30, c + 60, root, k + 1,
                        device_ns=(int((c + 34) * 1e3), int((c + 56) * 1e3)),
                        trips={"entry": 2, "ecc": 7, "pcg": 12, "seed": 1, "fold": 0}),
                  _span("fetch", c + 60, c + 80, root, k + 1)]
        events += [_ev("cuda_runtime", "cudaGraphLaunch", c + 32 + OFFSET, 2,
                       correlation=10 + k),
                   _ev("kernel", "k", c + 35 + OFFSET, 20, correlation=10 + k)]
    win = Window(calls, calls[0].start, calls[-1].end)
    ctx = SimpleNamespace(window=win, trace=devtrace.from_events(events), frames=win.frames)
    ctx._progspans = spans
    return ctx


def test_clock_is_the_median_middle_of_each_calls_bracket():
    ctx = _ctx()
    offset, residual = progspans.clock(ctx)
    assert offset == pytest.approx(OFFSET) and residual == pytest.approx(0.0)
    # the second call's span drawn 40 us late: the offset is the median of
    # the brackets' middles, and each bracket misses it by 10 us
    tr = ctx.trace
    late = dict(tr.spans[1], ts=tr.spans[1]["ts"] + 40)
    ctx.trace = devtrace.Trace(tr.window, tr.device, tr.runtime, [tr.spans[0], late])
    offset, residual = progspans.clock(ctx)
    assert offset == pytest.approx(OFFSET + 20) and residual == pytest.approx(10.0)
    # not one span a call: no mapping
    ctx.trace = devtrace.Trace(tr.window, tr.device, tr.runtime, tr.spans[:1])
    assert progspans.clock(ctx) is None


def test_idle_time_is_put_down_to_the_spans_that_hold_it():
    ctx = _ctx()
    read = {m: cell.module("metrics", m).read(ctx) for m in METRICS}
    # per frame: ingest 10 us idle, replay 30 - 20 (the kernel), fetch 20
    assert read["ingest_ms_per_frame"] == pytest.approx(0.010)
    assert read["ingest_idle_ms_per_frame"] == pytest.approx(0.010)
    assert read["launch_idle_ms_per_frame"] == pytest.approx(0.010)
    assert read["fetch_idle_ms_per_frame"] == pytest.approx(0.020)
    assert read["replay_device_ms_per_frame"] == pytest.approx(0.022)
    assert read["ecc_trips_per_frame"] == 7 and read["pcg_trips_per_frame"] == 12
    split = progspans.idle_split(ctx)
    # the window: 320 us, 40 of them busy
    assert split["total"] == pytest.approx(0.280 / 2)
    assert split["other"] == pytest.approx(0.0)
    assert split["outside"] == pytest.approx((0.280 - 0.080) / 2)
    assert sum(split[k] for k in ("ingest", "fetch", "launch", "other", "outside")) \
        == pytest.approx(split["total"])
    assert progspans.calls_outside(ctx) == (0, 0.0)
    # the idle stretches, longest first, named at their middles: 180 us
    # between the calls, 55 after the second call, 45 before the first;
    # the second call's fetch drawn 20 us longer holds the 55
    assert [(g[0], g[2]) for g in progspans.named_gaps(ctx, 3)] == [
        ("outside", pytest.approx(180e-6)), ("outside", pytest.approx(55e-6)),
        ("outside", pytest.approx(45e-6))]
    ctx._progspans[-1].end_ns += 20_000
    assert progspans.named_gaps(ctx, 2)[1][:2] == ["fetch", "call/python"]
    assert progspans.replay_kernel_gaps(ctx) == [pytest.approx((1.0, 1.0, 1.0))] * 2


def test_a_host_in_two_kinds_at_once_counts_once():
    ctx = _ctx()
    # an upload span inside the first fetch: its idle is the ingest's
    ctx._progspans.append(_span("upload", 1_000_065, 1_000_070, 3, 1))
    split = progspans.idle_split(ctx)
    assert split["ingest"] == pytest.approx(0.025 / 2)
    assert split["fetch"] == pytest.approx(0.035 / 2)
    assert sum(split[k] for k in ("ingest", "fetch", "launch", "other", "outside")) \
        == pytest.approx(split["total"])


def test_every_metric_is_none_with_nothing_to_read(monkeypatch):
    from vistaf_torch.utils import profiling
    empty = Window([Call(1.0, 1.1, 1, 0, None)], 1.0, 1.1)
    for trace in (None, _ctx().trace):
        # no records in the window (a window the recorder did not see)
        monkeypatch.setattr(profiling, "spans", lambda: [])
        ctx = SimpleNamespace(window=empty, trace=trace, frames=1)
        assert all(cell.module("metrics", m).read(ctx) is None for m in METRICS)
        # a program without the recorder (the parent of the one that added it)
        monkeypatch.delattr(profiling, "spans")
        ctx = SimpleNamespace(window=empty, trace=trace, frames=1)
        assert all(cell.module("metrics", m).read(ctx) is None for m in METRICS)
        monkeypatch.undo()
    # records but no trace: the host's time reads, the idle does not
    ctx = _ctx()
    ctx.trace = None
    assert cell.module("metrics", "ingest_ms_per_frame").read(ctx) == pytest.approx(0.010)
    assert cell.module("metrics", "fetch_idle_ms_per_frame").read(ctx) is None
    # replays without device records (a CPU run): no device time, no trips
    ctx = _ctx()
    for s in ctx._progspans:
        s.device_ns = s.trips = None
    for m in ("replay_device_ms_per_frame", "ecc_trips_per_frame", "pcg_trips_per_frame"):
        assert cell.module("metrics", m).read(ctx) is None


def test_the_recorder_under_the_driver_maps_into_each_call(one_thread):
    """The closed-loop driver over a stand-in entry that records the
    program's spans, traced on the CPU: each call's outermost span, mapped,
    inside its ``bench.call`` span; the host's time in the uploads read."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from vistaf_torch.utils import profiling
    drivers = cell.module("drivers", "closed_loop")

    class Stand:
        frames_per_call = 2

        def entry(self, x):
            with profiling.span("stream_step"):
                with profiling.span("upload"):
                    t = torch.full((64, 64), float(x))
                with profiling.span("eager"):
                    t = (t @ t).sum()
                with profiling.span("fetch"):
                    return float(t)

    profiling.spans_reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        win = drivers.run(Stand(), 0.2, iter(range(10**6)), spans=True)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        tr = devtrace.load(path)
    finally:
        os.unlink(path)
    ctx = SimpleNamespace(window=win, trace=tr, frames=win.frames)
    offset, residual = progspans.clock(ctx)
    assert residual == 0.0
    assert progspans.calls_outside(ctx) == (0, 0.0)
    roots = [s for s in progspans.recorded(ctx) if s.parent < 0]
    assert len(roots) == len(win.calls) and len({s.call for s in roots}) == len(roots)
    assert cell.module("metrics", "ingest_ms_per_frame").read(ctx) > 0
    # no device work: the card idles under every span
    assert cell.module("metrics", "fetch_idle_ms_per_frame").read(ctx) > 0
    assert cell.module("metrics", "replay_device_ms_per_frame").read(ctx) is None
    profiling.spans_reset()
