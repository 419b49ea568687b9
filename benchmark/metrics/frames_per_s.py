"""Camera frames completed over the whole window, over its seconds (a
stream step is one frame a stream)."""
from harness.window import frames_per_s


def read(ctx):
    return frames_per_s(ctx.window)
