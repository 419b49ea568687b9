"""K3's share of its roofline: the least time one H100 needs for the work
of K3's launches in a step (``kernel_work.k3`` of the configuration,
counted by ``harness/roofline.py``), over K3's traced device time a step
(``inpaint_mean_kernel`` and ``inpaint_steps_kernel``)."""
from harness.kernel_names import K3
from harness.kernel_share import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "k3", "inpaint_diffusion", K3)
