"""K6's share of its roofline: the least time one H100 needs for the work
of K6's launches in a step (``kernel_work.k6`` of the configuration: the
planes, their shape and the PCG's fixed iterations), over K6's traced
device time a step (``unwrap_kernel``)."""
from harness.kernel_names import K6
from harness.kernel_share import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "k6", "unwrap_wls", K6)
