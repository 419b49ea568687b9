"""CUDA runtime and driver calls the host issued in the window (graph
launches, kernel launches, copies, syncs, event records), per frame."""


def read(ctx):
    tr = ctx.trace
    if not tr or not ctx.frames or not tr.runtime:
        return None
    return len(tr.runtime) / ctx.frames
