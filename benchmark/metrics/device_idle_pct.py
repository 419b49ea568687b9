"""Share of the traced window with no kernel, copy or memset on the card,
from the union of their intervals over all streams."""
from harness import devtrace


def read(ctx):
    tr = ctx.trace
    if not tr or tr.window_us <= 0 or not tr.device:
        return None
    return 100.0 * (1.0 - devtrace.busy_us(tr) / tr.window_us)
