"""The program's own spans and counters in a traced window: the records of
``vistaf_torch.utils.profiling``'s recorder, which is on while the
window's ``torch.profiler`` trace collects.

The recorder keeps each span on the host's ``perf_counter`` clock, the
clock of the driver's ``Call`` readings; the trace has a clock of its own.
``clock`` maps the one onto the other: each call's ``bench.call`` span lies
between its ``Call.start`` and ``Call.end``, so the offset lies between
the span's start less ``Call.start`` and its end less ``Call.end``; the
offset taken is the median, over the window's calls, of the middle of
that bracket, and the residual is the most by which it falls outside a
call's bracket (0 where every call's bracket holds it).  The
idle time inside a kind of span is the part of the union of those spans,
mapped, that the union of the trace's device intervals leaves idle
(``devtrace.gaps``).

Where the program has no recorder (a checkout older than it) or recorded
nothing in the window, every reader returns None and raises nothing.
"""
from __future__ import annotations

import statistics
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from harness import devtrace
from harness.devtrace import Interval

# the spans of each kind, by the recorder's names (``vistaf.<name>`` in
# the trace)
INGEST = ("ingest", "upload", "stage")
FETCH = ("fetch",)
LAUNCH = ("replay",)


def recorded(ctx) -> Optional[list]:
    """The recorder's spans of the window's calls (those that started
    inside it), or None.  Read once a run: the read waits for the card to
    finish the replays' device records."""
    if hasattr(ctx, "_progspans"):
        return ctx._progspans
    got = None
    try:
        from vistaf_torch.utils import profiling
    except ImportError:
        profiling = None
    read = getattr(profiling, "spans", None)
    win = getattr(ctx, "window", None)
    if read is not None and win is not None and win.calls:
        lo, hi = win.start * 1e9, win.end * 1e9
        got = [s for s in read() if lo <= s.start_ns <= hi] or None
    ctx._progspans = got
    return got


def clock(ctx) -> Optional[Tuple[float, float]]:
    """(offset, residual) in microseconds: a ``perf_counter`` reading t
    (seconds) is at ``t * 1e6 + offset`` on the trace's clock.  None
    without a trace or where its ``bench.call`` spans are not one a call."""
    tr, win = ctx.trace, ctx.window
    calls = sorted(devtrace.spans(tr, "bench.call"), key=lambda e: float(e["ts"])) \
        if tr else []
    if not calls or len(calls) != len(win.calls):
        return None
    brackets = []
    for e, c in zip(calls, win.calls):
        a, b = devtrace.interval(e)
        brackets.append((b - c.end * 1e6, a - c.start * 1e6))    # (low, high)
    offset = statistics.median((lo + hi) / 2 for lo, hi in brackets)
    residual = max(max(lo - offset, offset - hi, 0.0) for lo, hi in brackets)
    return offset, residual


def mapped(spans: Iterable, offset: float) -> List[Interval]:
    """The spans' host intervals on the trace's clock."""
    return [(s.start_ns / 1e3 + offset, s.end_ns / 1e3 + offset) for s in spans]


def intersect(a: Sequence[Interval], b: Sequence[Interval]) -> List[Interval]:
    """What two sets of intervals share, as sorted disjoint intervals."""
    a, b = devtrace.union(a), devtrace.union(b)
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            out.append((lo, hi))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def overlap_us(a: Sequence[Interval], b: Sequence[Interval]) -> float:
    """Microseconds that two sets of intervals share."""
    return sum(hi - lo for lo, hi in intersect(a, b))


def _gaps(ctx) -> List[Interval]:
    if not hasattr(ctx, "_progspans_gaps"):
        ctx._progspans_gaps = devtrace.gaps(ctx.trace)
    return ctx._progspans_gaps


def host_ms_per_frame(ctx, names: Sequence[str]) -> Optional[float]:
    """Host milliseconds inside the spans ``names`` (their union), per
    frame."""
    sp = recorded(ctx)
    if not sp or not ctx.frames:
        return None
    mine = [(s.start_ns / 1e3, s.end_ns / 1e3) for s in sp if s.name in names]
    if not mine:
        return None
    return sum(b - a for a, b in devtrace.union(mine)) / 1e3 / ctx.frames


def idle_ms_per_frame(ctx, names: Sequence[str]) -> Optional[float]:
    """Milliseconds with nothing on the card while the host is inside the
    spans ``names``, per frame."""
    sp, clk = recorded(ctx), clock(ctx)
    if not sp or clk is None or not ctx.frames:
        return None
    mine = mapped((s for s in sp if s.name in names), clk[0])
    if not mine:
        return None
    return overlap_us(mine, _gaps(ctx)) / 1e3 / ctx.frames


def replays(ctx) -> List:
    """The window's replay spans whose device records were read."""
    return [s for s in recorded(ctx) or () if s.name in LAUNCH and s.device_ns is not None]


def replay_device_ms_per_frame(ctx) -> Optional[float]:
    """The replays' device spans, summed, per frame."""
    rs = replays(ctx)
    if not rs or not ctx.frames:
        return None
    return sum(b - a for a, b in (s.device_ns for s in rs)) / 1e6 / ctx.frames


def trips_per_frame(ctx, site: str) -> Optional[float]:
    """The condition setter's runs in ``site``'s slot over the window's
    replays, per frame (a WHILE site's trips)."""
    rs = [s for s in replays(ctx) if s.trips is not None and site in s.trips]
    if not rs or not ctx.frames:
        return None
    return sum(s.trips[site] for s in rs) / ctx.frames


def idle_split(ctx) -> Optional[Dict[str, float]]:
    """The window's idle device time in milliseconds per frame: inside the
    ingest, fetch and launch spans, inside any other program span, and
    outside every program span; ``total`` is all of it, which the five
    add up to (a host inside two kinds at once is counted in the first)."""
    sp, clk = recorded(ctx), clock(ctx)
    if not sp or clk is None or not ctx.frames:
        return None
    gaps = _gaps(ctx)
    out, taken = {}, []
    for kind, names in (("ingest", INGEST), ("fetch", FETCH), ("launch", LAUNCH)):
        mine = mapped((s for s in sp if s.name in names), clk[0])
        out[kind] = (overlap_us(mine, gaps) - overlap_us(mine, intersect(gaps, taken))) / 1e3
        taken = devtrace.union(taken + mine)
    every = devtrace.union(mapped(sp, clk[0]))
    out["other"] = (overlap_us(every, gaps) - overlap_us(taken, gaps)) / 1e3
    total = sum(b - a for a, b in gaps) / 1e3
    out["outside"] = total - overlap_us(every, gaps) / 1e3
    out["total"] = total
    return {k: v / ctx.frames for k, v in out.items()}


def named_gaps(ctx, n: int = 10) -> Optional[List[List]]:
    """The ``n`` longest idle stretches of the window, each named by the
    innermost program span the host was in at its middle (``outside``
    where none) and by ``devtrace.named_at``: [[span, name, seconds], ...]."""
    sp, clk = recorded(ctx), clock(ctx)
    if not sp or clk is None:
        return None
    held = list(zip(mapped(sp, clk[0]), sp))
    out = []
    for a, b in sorted(_gaps(ctx), key=lambda g: g[0] - g[1])[:n]:
        t = (a + b) / 2
        inside = [(hi - lo, s.name) for (lo, hi), s in held if lo <= t < hi]
        out.append([min(inside)[1] if inside else "outside",
                    devtrace.named_at(ctx.trace, t), (b - a) * 1e-6])
    return out


def calls_outside(ctx) -> Optional[Tuple[int, float]]:
    """How many of the window's program calls (their outermost spans),
    mapped, do not lie inside their ``bench.call`` span, and the largest
    excess in microseconds."""
    sp, clk = recorded(ctx), clock(ctx)
    if not sp or clk is None:
        return None
    calls = sorted((devtrace.interval(e) for e in devtrace.spans(ctx.trace, "bench.call")))
    n, worst = 0, 0.0
    for a, b in mapped((s for s in sp if s.parent < 0), clk[0]):
        host = next((c for c in calls if c[0] <= (a + b) / 2 <= c[1]), None)
        excess = max(host[0] - a, b - host[1], 0.0) if host else b - a
        n += excess > 0
        worst = max(worst, excess)
    return n, worst


def replay_kernel_gaps(ctx) -> Optional[List[Tuple[float, float, float]]]:
    """For each replay, in microseconds: its first kernel's start less its
    device span's start; the same less the later of the span's start and
    the return of its ``cudaGraphLaunch`` (under the profiler's per-node
    tracing the launch holds the graph back); its device span's end less
    its last kernel's end.  Each at least 0 where the span covers the
    kernels, which are those the trace ties (by correlation id) to the
    ``cudaGraphLaunch`` made inside the replay's span."""
    rs, clk = replays(ctx), clock(ctx)
    if not rs or clk is None:
        return None
    launches = [e for e in ctx.trace.runtime if e["name"] == "cudaGraphLaunch"]
    by_corr: Dict[int, List[Interval]] = {}
    for e in ctx.trace.device:
        by_corr.setdefault(devtrace.correlation(e), []).append(devtrace.interval(e))
    out = []
    for s in rs:
        (a, b), = mapped([s], clk[0])
        mine = [devtrace.interval(e) + (devtrace.correlation(e),) for e in launches
                if a <= devtrace.interval(e)[0] <= b]
        ks = [iv for *_, c in mine for iv in by_corr.get(c, ())]
        if not ks:
            continue
        d0, d1 = s.device_ns[0] / 1e3 + clk[0], s.device_ns[1] / 1e3 + clk[0]
        k0 = min(k[0] for k in ks)
        out.append((k0 - d0, k0 - max(d0, mine[0][1]), d1 - max(k[1] for k in ks)))
    return out or None
