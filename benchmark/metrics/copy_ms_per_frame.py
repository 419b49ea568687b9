"""Device time of the copies between host and card (the trace's memcpy
events), per frame."""
from harness import devtrace


def read(ctx):
    tr = ctx.trace
    if not tr or not ctx.frames:
        return None
    us = sum(b - a for a, b in (devtrace.interval(e) for e in tr.device
                                if e.get("cat") == "gpu_memcpy"))
    return us / 1e3 / ctx.frames if us > 0 else None
