"""Masked percentile and mean/min/max reductions (JAX ``ops/percentile.py``).

Two methods are ported: ``sort`` (the parity preset's: NumPy's linear
interpolation over a full sort, the JAX ``masked_percentile``, bit-equal to
it on the CPU) and ``hist_pallas`` (the deploy preset's: the K1 kernel,
``kernels/quantile_kernel.py``).  The ``hist``, histogram-rows and bisection
XLA paths are no preset's route and are not ported.  Reductions run over
the trailing (H, W) dimensions, so a (2, H, W) pair gives one value per
plane.
"""
from __future__ import annotations

import numpy as np
import torch

from vistaf_torch.kernels.quantile_kernel import masked_quantiles

_BIG = 3.0e38


def masked_percentile(arr: torch.Tensor, mask, q, fallback: float = 0.0) -> torch.Tensor:
    """np.percentile(arr[mask], q) over the trailing (H, W) dimensions with
    linear interpolation, NaN and inf excluded; ``mask`` broadcasts to
    ``arr`` or is None (every finite pixel).  A scalar ``q`` gives (...,), a
    tuple (..., Q); an empty selection gives ``fallback``.  The position
    arithmetic is the JAX package's, in float32."""
    x = arr.to(torch.float32)
    m = torch.isfinite(x) if mask is None else mask.expand(x.shape) & torch.isfinite(x)
    x = x.reshape(*x.shape[:-2], -1)
    m = m.reshape(x.shape)
    n = m.sum(dim=-1)
    xs = torch.sort(torch.where(m, x, _BIG), dim=-1).values
    nf1 = n.to(torch.float32) - 1.0
    hi_max = torch.clamp(n - 1, min=0)
    outs = []
    for qq in (q if isinstance(q, (tuple, list)) else (q,)):
        pos = torch.clamp(float(np.float32(qq) / np.float32(100.0)) * nf1, min=0.0)
        lo = torch.floor(pos).to(torch.int64)
        hi = torch.minimum(lo + 1, hi_max)
        frac = pos - lo.to(torch.float32)
        v = (xs.gather(-1, lo[..., None])[..., 0] * (1.0 - frac)
             + xs.gather(-1, hi[..., None])[..., 0] * frac)
        outs.append(torch.where(n > 0, v, float(fallback)))
    return torch.stack(outs, dim=-1) if isinstance(q, (tuple, list)) else outs[0]


def masked_median(arr: torch.Tensor, mask, fallback: float = 0.0) -> torch.Tensor:
    return masked_percentile(arr, mask, 50.0, fallback=fallback)


def get_percentile_fn(method: str):
    """``pctl(arr, mask, q)``: q a scalar gives (...,), a tuple (..., Q)."""
    if method == "sort":
        return masked_percentile
    if method != "hist_pallas":
        raise ValueError(f"percentile method {method!r} is not ported "
                         "(vistaf_torch runs 'sort' and 'hist_pallas')")

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
