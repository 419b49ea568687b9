"""The ECC Gauss-Newton loops' trips on the card (the condition setter's
``ecc`` slot, read around each replay), over the window, per frame."""
from harness import progspans


def read(ctx):
    return progspans.trips_per_frame(ctx, "ecc")
