"""The arithmetic that the kernels' roofline metrics share."""
from harness import devtrace
from harness.kernel_names import base_name
from harness.roofline import least_ms


def roofline_pct(ctx, key: str, kernel: str, names) -> float:
    """100 x the least milliseconds of the configuration's launches of
    ``kernel`` a step, times the window's steps, over the traced device
    time of the kernels ``names``; None where the configuration states no
    such launches or the trace holds none of those kernels."""
    cases = ctx.cfg.get("kernel_work", {}).get(key)
    tr = ctx.trace
    if not cases or not tr or not ctx.steps:
        return None
    us = sum(b - a for a, b in (devtrace.interval(e) for e in tr.device
                                if e.get("cat") == "kernel" and base_name(e["name"]) in names))
    if us <= 0:
        return None
    return 100.0 * least_ms(kernel, cases) * ctx.steps / (us / 1e3)
