"""K1: masked quantiles by bisection (``csrc/quantile.cu``).

Replaces the JAX package's ``pallas/quantile_kernel.py::masked_quantiles_pallas``:
per quantile q, n = count(mask & finite), [lo, hi] = the masked min/max,
then ``LEVELS`` (23) bisection levels of ``cnt = count(x <= mid & mask)`` with
``go_hi = cnt <= f32(q/100) * max(n - 1, 0)``; the result is the bracket
midpoint, 0 for an empty mask.  The counts are exact, so kernel and plain
version agree bit for bit.

On the H100 one CTA per plane runs every level (a 236x236 plane is 55,696
elements); each level is a count pass plus a block reduction, so the kernel
is bound by one SM's load bandwidth and the barrier latency of 23 levels per
quantile, not by the card.  A later PR could split the plane over a cluster
of CTAs with distributed shared memory, or count several levels' midpoints
per pass.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import numpy as np
import torch

from vistaf_torch import kernels

_BIG = 3.0e38


def bisect_levels(bins: int, refine: int) -> int:
    """Bisection depth with a bracket at least as tight as the (bins,
    1+refine)-level histogram ladder, plus 2 levels of margin."""
    return int(np.ceil((1 + refine) * np.log2(bins))) + 2


LEVELS = bisect_levels(128, 2)
MAX_QUANTILES = 8          # kMaxQuantiles in csrc/quantile.cu


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
                           qs: Sequence[float]) -> torch.Tensor:
    """Plain PyTorch version of the kernel: (..., H, W) -> (..., Q)."""
    x = arr.to(torch.float32)
    lead = x.shape[:-2]
    x = x.reshape(-1, x.shape[-2] * x.shape[-1])
    m = torch.isfinite(x)
    if mask is not None:
        m = m & mask.expand(arr.shape).reshape(x.shape)
    n = m.sum(dim=1).to(torch.float32)
    lo = torch.where(m, x, _BIG).amin(dim=1)
    hi = torch.where(m, x, -_BIG).amax(dim=1)
    q = len(qs)
    fr = torch.as_tensor(_fractions(qs), device=x.device)
    xs = torch.where(m, x, float("nan"))
    v = bisect_rows(xs, n, fr, lo[:, None].expand(-1, q), hi[:, None].expand(-1, q),
                    LEVELS)
    v = torch.where(n[:, None] > 0, v, 0.0)
    return v.reshape(*lead, q)


def masked_quantiles(arr: torch.Tensor, mask: Optional[torch.Tensor],
                     qs: Sequence[float]) -> torch.Tensor:
    """Masked bisection quantiles of the trailing (H, W) planes of ``arr``
    over ``mask`` (None = everywhere): returns (..., len(qs)) float32."""
    qs = tuple(float(q) for q in qs)
    if kernels.route(arr) == "cpu":
        return masked_quantiles_plain(arr, mask, qs)
    if not 1 <= len(qs) <= MAX_QUANTILES:
        raise ValueError(f"masked_quantiles: 1 to {MAX_QUANTILES} quantiles per "
                         f"launch, got {len(qs)}")
    x = arr.to(torch.float32).contiguous()
    m = (torch.ones_like(x, dtype=torch.bool) if mask is None
         else mask.to(torch.bool).expand(x.shape).contiguous())
    kernels.check_cuda("masked_quantiles", x, m)
    lead = x.shape[:-2]
    batch = int(np.prod(lead)) if lead else 1
    n = x.shape[-2] * x.shape[-1]
    folded = torch.empty_like(x)
    out = torch.empty((batch, len(qs)), dtype=torch.float32, device=x.device)
    fr = (ctypes.c_float * len(qs))(*_fractions(qs).tolist())
    kernels.launch("vt_masked_quantiles", "masked_quantiles", x.device,
                   x.data_ptr(), m.data_ptr(), folded.data_ptr(), out.data_ptr(),
                   batch, n, ctypes.cast(fr, ctypes.c_void_p), len(qs), LEVELS)
    return out.reshape(*lead, len(qs))
