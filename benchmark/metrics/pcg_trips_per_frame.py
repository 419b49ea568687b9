"""The WLS unwrap's PCG trips on the card (the condition setter's ``pcg``
slot, read around each replay), over the window, per frame."""
from harness import progspans


def read(ctx):
    return progspans.trips_per_frame(ctx, "pcg")
