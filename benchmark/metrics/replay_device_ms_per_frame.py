"""The program's CUDA graph replays on the card: each replay's device span
(a CUDA event before and after it on its stream, put on the host's clock
by the recorder), summed over the window, per frame."""
from harness import progspans


def read(ctx):
    return progspans.replay_device_ms_per_frame(ctx)
