"""The names of the program's hand-written kernels: every ``__global__``
function of ``vistaf_torch/csrc/*.cu`` at commit
98381829b5ef1b546fde2f6549f168989515a1b3, frozen, so that a kernel a later
change adds or renames is counted among PyTorch's until the benchmark
names it.  ``base_name`` reads a device trace's kernel name."""
from __future__ import annotations

from typing import Optional

CSRC_KERNELS = {
    "ccl.cu": ("ccl_tile_kernel", "ccl_border_kernel", "ccl_flatten_kernel"),
    "ecc_gn_loop.cu": ("gn_loop_kernel",),
    "ecc_loop.cu": ("ecc_loop_kernel",),
    "graph_cond.cu": ("set_conditional_kernel",),
    "inpaint.cu": ("inpaint_mean_kernel", "inpaint_steps_kernel"),
    "polyfit.cu": ("polyfit_kernel",),
    "quantile.cu": ("quantile_range_kernel", "quantile_pass_kernel", "quantile_finish_kernel",
                    "mad_pass_kernel", "median_mad_finish_kernel"),
    "temp.cu": ("fused_temp_kernel",),
    "unwrap.cu": ("unwrap_kernel",),
}
HAND_WRITTEN = frozenset(n for names in CSRC_KERNELS.values() for n in names)
# K3 and K6, as the roofline metrics read them
K3 = frozenset(CSRC_KERNELS["inpaint.cu"])
K6 = frozenset(CSRC_KERNELS["unwrap.cu"])

def base_name(trace_name: str) -> str:
    """The function's own name in a trace's kernel name: the identifier
    after the last ``::`` before the argument list, template arguments
    dropped (``void (anonymous namespace)::unwrap_kernel<true>(Args)`` ->
    ``unwrap_kernel``)."""
    head = trace_name[5:] if trace_name.startswith("void ") else trace_name
    head = head.replace("(anonymous namespace)::", "")
    head = head.split("(", 1)[0].split("<", 1)[0]
    return head.rsplit("::", 1)[-1].strip()


def hand_written(trace_name: str) -> Optional[str]:
    """The csrc kernel a trace's kernel name is, or None."""
    name = base_name(trace_name)
    return name if name in HAND_WRITTEN else None
