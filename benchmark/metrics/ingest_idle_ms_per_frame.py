"""Time with nothing on the card (the union of the trace's device
intervals) while the host is inside the program's upload spans
(``vistaf.ingest``, ``vistaf.upload``, ``vistaf.stage``), per frame: the
card waiting for the host's staging."""
from harness import progspans


def read(ctx):
    return progspans.idle_ms_per_frame(ctx, progspans.INGEST)
