"""Device operations that ran (kernels, copies, memsets), per frame."""


def read(ctx):
    tr = ctx.trace
    if not tr or not ctx.frames or not tr.device:
        return None
    return len(tr.device) / ctx.frames
