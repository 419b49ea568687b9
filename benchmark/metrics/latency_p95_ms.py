"""The 95th percentile of every call's latency in the window: from handing
the entry host uint8 frames to its results as host numbers; each frame of
a step has its step's latency."""
from harness.window import latency_percentile_ms


def read(ctx):
    return latency_percentile_ms(ctx.window, 95.0)
