"""Device time of every kernel that is not one of the program's
hand-written ``csrc`` kernels (``harness/kernel_names.py``): PyTorch's
FFTs, matmul blurs and elementwise chains, per frame."""
from harness import devtrace
from harness.kernel_names import hand_written


def read(ctx):
    tr = ctx.trace
    if not tr or not ctx.frames:
        return None
    us = sum(b - a for a, b in (devtrace.interval(e) for e in tr.device
                                if e.get("cat") == "kernel" and not hand_written(e["name"])))
    return us / 1e3 / ctx.frames if us > 0 else None
