"""Time with nothing on the card while the host is inside the program's
``vistaf.fetch`` spans (the results' copies to the host and their host
assembly), per frame."""
from harness import progspans


def read(ctx):
    return progspans.idle_ms_per_frame(ctx, progspans.FETCH)
