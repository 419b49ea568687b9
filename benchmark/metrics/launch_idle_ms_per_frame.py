"""Time with nothing on the card while the host is inside the program's
``vistaf.replay`` spans (a CUDA graph's static-input copies, its launch and
its outputs' clones), per frame."""
from harness import progspans


def read(ctx):
    return progspans.idle_ms_per_frame(ctx, progspans.LAUNCH)
