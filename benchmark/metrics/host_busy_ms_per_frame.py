"""The host's time inside the entry's calls (the benchmark's ``bench.call``
spans), less the time it waited there in runtime calls that wait for the
card (synchronizations, copies to the host), per frame: staging, uploads,
graph launch and result assembly."""
from harness import devtrace


def read(ctx):
    tr = ctx.trace
    calls = devtrace.spans(tr, "bench.call") if tr else []
    if not calls or not ctx.frames:
        return None
    waits = devtrace.waits(tr)
    busy = 0.0
    for e in calls:
        a, b = devtrace.interval(e)
        busy += (b - a) - devtrace.covered_us((a, b), waits)
    return busy / 1e3 / ctx.frames
