"""K1: masked quantiles by bisection, and K2: the fused masked median and
MAD (``csrc/quantile.cu``).

K1 replaces the JAX package's ``pallas/quantile_kernel.py::masked_quantiles_pallas``:
per quantile q, n = count(mask & finite), [lo, hi] = the masked min/max,
then ``LEVELS`` (23) bisection levels of ``cnt = count(x <= mid & mask)`` with
``go_hi = cnt <= f32(q/100) * max(n - 1, 0)``; the result is the bracket
midpoint, 0 for an empty mask.  K2 replaces its ``masked_median_mad_pallas``:
the median by ``MAD_LEVELS`` (16, ``refine=1``) levels over [lo, hi], then
the MAD as the median of |x - med| over [0, max(hi - med, med - lo)], both 0
for an empty mask; K7 takes its robust scale on the same ladder.  The counts
are exact, so kernels and plain versions agree bit for bit.

Routing (``kernels/__init__.py``): ``fits`` copies the JAX package's VMEM
budget (``quantile_kernel.py:73-77``: 8 bytes per element).  K1 runs at
every size: above the budget the JAX package takes
``masked_percentile_bisect_multi`` with the same levels, the same
computation.  K2 above the budget follows the JAX package to the bisection
pair whose MAD bracket is the range of |x - med| (``median_mad_above_budget``):
two K1 launches of one quantile each at ``MAD_LEVELS``, so on the card no
plain path stands beside a kernel that does the same work.

On the H100 (``csrc/quantile.cu``'s note has the details), K1 must read each
value and mask byte once, 12 us of HBM time at the 8.3 M-element 4K gray; a
bisection counts the plane once per level.  K1 and K2 spread each plane over
many CTAs (up to three per SM) and take the levels 8 at a time, on the
bisection ladder of ``csrc/ladder.cuh``: a range pass, then per 8 levels one
pass in which every valid element descends the next 8 levels of the
bisection tree to one of 256 leaves, counted into an integer histogram, then
a finish launch.  Every CTA walks the histograms of the earlier passes to the
same bracket.  The in-order midpoints of the tree never decrease, so the leaf
sums are the bisection's exact counts and the walk takes its decisions, bit
for bit (``tests/test_torch_quantile_ladder.py`` holds a numpy model of both
ladders to the plain versions).  One K1 call reads the plane 1 + ceil(levels
/ 8) times whatever the number of quantiles, in 2 + ceil(levels / 8)
launches; K2 runs the median's passes and then as many over |x - med|, each
CTA replaying the median's walk first: 6 launches at ``MAD_LEVELS``.  The C
call enqueues them all, and the launch count counts it as one.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Sequence

import numpy as np
import torch

from plainref import kernels

_BIG = 3.0e38


def bisect_levels(bins: int, refine: int) -> int:
    """Bisection depth with a bracket at least as tight as the (bins,
    1+refine)-level histogram ladder, plus 2 levels of margin."""
    return int(np.ceil((1 + refine) * np.log2(bins))) + 2


LEVELS = bisect_levels(128, 2)
MAD_LEVELS = bisect_levels(128, 1)
MAX_QUANTILES = 8          # kMaxQuantiles in csrc/quantile.cu
# the JAX package's _VMEM_BUDGET_BYTES (pallas/quantile_kernel.py:73): data
# and mask resident, 8 bytes per element of one plane
_VMEM_BUDGET_BYTES = 13_107_200


def fits(shape) -> bool:
    """The JAX package's ``_fits_vmem`` for one (H, W) plane."""
    return int(np.prod(shape[-2:])) * 8 <= _VMEM_BUDGET_BYTES


def _fractions(qs: Sequence[float]) -> np.ndarray:
    return np.asarray([np.float32(q / 100.0) for q in qs], np.float32)


def bisect_rows(xs: torch.Tensor, n: torch.Tensor, fractions: torch.Tensor,
                lo: torch.Tensor, hi: torch.Tensor, levels: int) -> torch.Tensor:
    """Bisection on (B, N) rows whose masked-out entries are NaN, for (Q,)
    quantile fractions and (B, Q) starting brackets.  Returns (B, Q)."""
    target = fractions[None, :] * torch.clamp(n - 1.0, min=0.0)[:, None]
    for _ in range(levels):
        mid = 0.5 * (lo + hi)
        cnt = (xs[:, :, None] <= mid[:, None, :]).sum(dim=1).to(torch.float32)
        go_hi = cnt <= target
        lo, hi = torch.where(go_hi, mid, lo), torch.where(go_hi, hi, mid)
    return 0.5 * (lo + hi)


def masked_quantiles_plain(arr: torch.Tensor, mask: Optional[torch.Tensor],
                           qs: Sequence[float], levels: int = LEVELS) -> torch.Tensor:
    """Plain PyTorch version of the kernel: (..., H, W) -> (..., Q)."""
    lead = arr.shape[:-2]
    xs, n, lo, hi = _rows(arr, mask)
    q = len(qs)
    fr = torch.as_tensor(_fractions(qs), device=xs.device)
    v = bisect_rows(xs, n, fr, lo[:, None].expand(-1, q), hi[:, None].expand(-1, q),
                    levels)
    v = torch.where(n[:, None] > 0, v, 0.0)
    return v.reshape(*lead, q)


def masked_quantiles(arr: torch.Tensor, mask: Optional[torch.Tensor],
                     qs: Sequence[float], levels: int = LEVELS) -> torch.Tensor:
    """Masked bisection quantiles of the trailing (H, W) planes of ``arr``
    over ``mask`` (None = everywhere), ``levels`` bisection levels: returns
    (..., len(qs)) float32."""
    qs = tuple(float(q) for q in qs)
    if kernels.route(arr) == "cpu":
        return masked_quantiles_plain(arr, mask, qs, levels)
    if not 1 <= len(qs) <= MAX_QUANTILES:
        raise ValueError(f"masked_quantiles: 1 to {MAX_QUANTILES} quantiles per "
                         f"launch, got {len(qs)}")
    x = arr.to(torch.float32).contiguous()
    m = (torch.ones_like(x, dtype=torch.bool) if mask is None
         else mask.to(torch.bool).expand(x.shape).contiguous())
    kernels.check_cuda("masked_quantiles", x, m)
    lead = x.shape[:-2]
    batch = math.prod(lead)
    n = x.shape[-2] * x.shape[-1]
    words = kernels.library().vt_masked_quantiles_scratch(batch, n, len(qs), int(levels))
    # one allocation: the kernel's int32 scratch, then the (batch, Q) result
    buf = torch.empty(words + batch * len(qs), dtype=torch.int32, device=x.device)
    out = buf[words:].view(torch.float32)
    fr = (ctypes.c_float * len(qs))(*_fractions(qs).tolist())
    kernels.launch("vt_masked_quantiles", "masked_quantiles", x.device,
                   x.data_ptr(), m.data_ptr(), buf.data_ptr(), out.data_ptr(),
                   batch, n, ctypes.cast(fr, ctypes.c_void_p), len(qs), int(levels))
    return out.reshape(*lead, len(qs))


def _rows(arr: torch.Tensor, mask: Optional[torch.Tensor]):
    """(B, N) float32 rows of the trailing planes with NaN outside
    mask & finite, and their counts, minima and maxima."""
    x = arr.to(torch.float32)
    x = x.reshape(-1, x.shape[-2] * x.shape[-1])
    m = torch.isfinite(x)
    if mask is not None:
        m = m & mask.expand(arr.shape).reshape(x.shape)
    n = m.sum(dim=1).to(torch.float32)
    lo = torch.where(m, x, _BIG).amin(dim=1)
    hi = torch.where(m, x, -_BIG).amax(dim=1)
    return torch.where(m, x, float("nan")), n, lo, hi


def median_mad_rows(xs: torch.Tensor, n: torch.Tensor, lo: torch.Tensor,
                    hi: torch.Tensor, levels: int = MAD_LEVELS):
    """The fused pair on (B, N) rows whose masked-out entries are NaN: the
    median over [lo, hi], then the median of |x - med| over
    [0, max(hi - med, med - lo)].  Returns two (B,) tensors."""
    half = torch.full((1,), 0.5, dtype=torch.float32, device=xs.device)
    med = bisect_rows(xs, n, half, lo[:, None], hi[:, None], levels)[:, 0]
    ax = torch.abs(xs - med[:, None])
    span = torch.maximum(hi - med, med - lo)
    mad = bisect_rows(ax, n, half, torch.zeros_like(span)[:, None], span[:, None],
                      levels)[:, 0]
    return med, mad


def masked_median_mad_plain(arr: torch.Tensor, mask: Optional[torch.Tensor]):
    """Plain PyTorch version of K2: (..., H, W) -> ((...,) median, (...,) MAD)."""
    lead = arr.shape[:-2]
    xs, n, lo, hi = _rows(arr, mask)
    med, mad = median_mad_rows(xs, n, lo, hi)
    ok = n > 0
    return (torch.where(ok, med, 0.0).reshape(lead),
            torch.where(ok, mad, 0.0).reshape(lead))


def median_mad_above_budget(arr: torch.Tensor, mask: Optional[torch.Tensor]):
    """The JAX package's route above K2's budget: two bisection quantiles
    (``masked_percentile_bisect_multi``), the MAD bracket being the masked
    range of |x - med|.  Each is a K1 launch on a CUDA tensor."""
    med = masked_quantiles(arr, mask, (50.0,), levels=MAD_LEVELS)[..., 0]
    dev = torch.abs(arr.to(torch.float32) - med[..., None, None])
    mad = masked_quantiles(dev, mask, (50.0,), levels=MAD_LEVELS)[..., 0]
    return med, mad


def masked_median_mad(arr: torch.Tensor, mask: Optional[torch.Tensor]):
    """(median, MAD) of the trailing (H, W) planes of ``arr`` over ``mask``
    (None = everywhere), 0 for an empty mask: two float32 tensors of the
    leading shape."""
    if not fits(arr.shape):
        return median_mad_above_budget(arr, mask)
    if kernels.route(arr) == "cpu":
        return masked_median_mad_plain(arr, mask)
    x = arr.to(torch.float32).contiguous()
    m = (torch.ones_like(x, dtype=torch.bool) if mask is None
         else mask.to(torch.bool).expand(x.shape).contiguous())
    kernels.check_cuda("masked_median_mad", x, m)
    lead = x.shape[:-2]
    batch = math.prod(lead)
    n = x.shape[-2] * x.shape[-1]
    words = kernels.library().vt_masked_median_mad_scratch(batch, n, MAD_LEVELS)
    # one allocation: the kernel's int32 scratch, then the (batch, 2) result
    buf = torch.empty(words + 2 * batch, dtype=torch.int32, device=x.device)
    out = buf[words:].view(torch.float32).reshape(batch, 2)
    kernels.launch("vt_masked_median_mad", "masked_median_mad", x.device,
                   x.data_ptr(), m.data_ptr(), buf.data_ptr(), out.data_ptr(),
                   batch, n, MAD_LEVELS)
    return out[:, 0].reshape(lead), out[:, 1].reshape(lead)
