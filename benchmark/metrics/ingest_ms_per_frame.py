"""The host's time inside the program's upload spans (``vistaf.ingest``,
``vistaf.upload``, ``vistaf.stage``; their union), per frame: pinning or
staging the frames and enqueuing their copies to the card."""
from harness import progspans


def read(ctx):
    return progspans.host_ms_per_frame(ctx, progspans.INGEST)
