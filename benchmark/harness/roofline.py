"""Bytes and float32 operations of the hand-written kernels, from their
shapes and iteration counts, and the least time one H100 needs for them.

A frozen copy of ``chip_smoke.py::work`` and ``bound_ms`` (commit
98381829b5ef1b546fde2f6549f168989515a1b3) for the kernels whose work the
shapes and fixed iteration counts set: each input read once and each output
written once; operations counted per element from the algorithm (a
compare, add, multiply or transcendental is one).  The counts follow the
algorithm, not the code that runs it, so a redesigned kernel is held to the
same work.
"""
from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

# H100 SXM peaks (NVIDIA data sheet, 700 W): HBM bytes/s, float32 FLOP/s
# outside the tensor cores
HBM_BPS, FP32_OPS = 3.35e12, 67e12
# the bisection ladders' levels (``kernels/quantile_kernel.py``:
# bisect_levels(128, 2) and bisect_levels(128, 1))
QUANTILE_LEVELS, MAD_LEVELS = 16, 8


def pad_up(n: int, m: int) -> int:
    return -(-n // m) * m


def work(kernel: str, case: Dict) -> Tuple[int, int]:
    """(bytes, float32 operations) of one launch.  ``case`` holds
    ``shape`` (the planes, leading axes included) and the kernel's
    counts: ``iters`` (K3 steps, K6 PCG iterations), ``quantiles`` (K1)."""
    shape = tuple(int(s) for s in case["shape"])
    n = math.prod(shape)
    if kernel == "inpaint_diffusion":       # per step: two 3x3 box sums, update
        return 9 * n, n * (2 + 24 * int(case["iters"]))
    if kernel == "unwrap_wls":              # PCG: 4 DCT products a preconditioner
        h, w = shape[-2:]
        hp, wp = pad_up(h, 8), pad_up(w, 128)
        planes = n // (h * w)
        apps = int(case["iters"]) + 1
        mats = 2 * (hp * hp + wp * wp) + hp * wp
        return 9 * n + 4 * mats, planes * (apps * 4 * hp * wp * (hp + wp)
                                           + hp * wp * 40 * apps)
    if kernel == "masked_quantiles":        # min, max; per level a compare and a count
        q = int(case["quantiles"])
        planes = n // (shape[-2] * shape[-1])
        return 5 * n + 4 * planes * q, n * (2 + 2 * QUANTILE_LEVELS * q)
    if kernel == "masked_median_mad":       # median levels; |x - med|; MAD levels
        return 5 * n + 8, n * (2 + 2 * MAD_LEVELS + 2 + 2 * MAD_LEVELS)
    if kernel == "label_components":        # the mask in, int64 labels out
        return 9 * n, 6 * n
    raise KeyError(kernel)


def bound_ms(nbytes: int, ops: int) -> Tuple[float, str]:
    """The least milliseconds and what bounds them ('bytes' or 'operations')."""
    t_bytes, t_ops = nbytes / HBM_BPS * 1e3, ops / FP32_OPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def least_ms(kernel: str, cases: Sequence[Dict]) -> float:
    """The least milliseconds of all of ``cases``' launches together."""
    return sum(bound_ms(*work(kernel, c))[0] for c in cases)
