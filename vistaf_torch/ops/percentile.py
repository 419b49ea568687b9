"""Masked percentile and mean/min/max reductions (JAX ``ops/percentile.py``).

The port runs the deploy preset's method, ``hist_pallas``, which is the K1
kernel (``kernels/quantile_kernel.py``); the other methods (``sort``,
``hist``, the histogram-rows and bisection XLA paths) are not ported yet.
Reductions run over the trailing (H, W) dimensions, so a (2, H, W) pair
gives one value per plane.
"""
from __future__ import annotations

import torch

from vistaf_torch.kernels.quantile_kernel import masked_quantiles

_BIG = 3.0e38


def get_percentile_fn(method: str):
    """``pctl(arr, mask, q)``: q a scalar gives (...,), a tuple (..., Q)."""
    if method != "hist_pallas":
        raise ValueError(f"percentile method {method!r} is not ported "
                         "(vistaf_torch runs 'hist_pallas')")

    def pctl(arr, mask, q):
        if isinstance(q, (tuple, list)):
            return masked_quantiles(arr, mask, tuple(q))
        return masked_quantiles(arr, mask, (q,))[..., 0]

    return pctl


def _valid(arr: torch.Tensor, mask: torch.Tensor):
    x = arr.to(torch.float32)
    return x, mask & torch.isfinite(x)


def masked_mean(arr: torch.Tensor, mask: torch.Tensor, fallback: float = 0.0) -> torch.Tensor:
    """Mean over the finite ``mask`` pixels, ``fallback`` where there are none."""
    x, m = _valid(arr, mask)
    n = m.sum(dim=(-2, -1)).to(torch.float32)
    s = torch.where(m, x, 0.0).sum(dim=(-2, -1))
    return torch.where(n > 0, s / torch.clamp(n, min=1.0), float(fallback))


def masked_min(arr: torch.Tensor, mask: torch.Tensor, fallback: float = 0.0) -> torch.Tensor:
    """Minimum over the finite ``mask`` pixels, ``fallback`` where there are none."""
    x, m = _valid(arr, mask)
    v = torch.where(m, x, _BIG).amin(dim=(-2, -1))
    return torch.where(m.any(dim=-1).any(dim=-1), v, float(fallback))


def masked_max(arr: torch.Tensor, mask: torch.Tensor, fallback: float = 0.0) -> torch.Tensor:
    """Maximum over the finite ``mask`` pixels, ``fallback`` where there are none."""
    x, m = _valid(arr, mask)
    v = torch.where(m, x, -_BIG).amax(dim=(-2, -1))
    return torch.where(m.any(dim=-1).any(dim=-1), v, float(fallback))
