"""Masked percentile and mean/min/max reductions (JAX ``ops/percentile.py``).

The JAX package's three methods are ported: ``sort`` (the parity presets':
NumPy's linear interpolation over a full sort, the JAX ``masked_percentile``,
bit-equal to it on the CPU), ``hist`` (the JAX histogram refinement,
``masked_percentile_hist``, ``_hist_multi`` and ``_hist_rows``, the last the
force demod's bad-pixel thresholds) and ``hist_pallas`` (the deploy presets':
the K1 kernel, ``kernels/quantile_kernel.py``).  The bisection ladder is
only the JAX kernels' above-budget fallback, which the port's kernels do not
need.  Reductions run over the trailing (H, W) dimensions, so a (2, H, W)
pair gives one value per plane.
"""
from __future__ import annotations

import numpy as np
import torch

from plainref.kernels.quantile_kernel import masked_quantiles
from plainref.ops.streams import each

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


def _hist_counts(x: torch.Tensor, m: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    """float32 counts[..., b] of the ``m`` elements of ``x`` (..., N) with
    x <= edges[..., b], for non-decreasing edges (..., B): each element
    counted once in the bin of the first edge >= it, then a running sum
    (the JAX (N, B) compare-and-sum, exact below 2**24 elements)."""
    idx = torch.searchsorted(edges, x, right=False)
    B = edges.shape[-1]
    idx = torch.where(m, idx, B)                       # unmasked: past the last edge
    hist = torch.zeros((*x.shape[:-1], B + 1), dtype=torch.int64, device=x.device)
    hist.scatter_add_(-1, idx, torch.ones_like(idx))
    return torch.cumsum(hist[..., :B], dim=-1).to(torch.float32)


def _hist_setup(arr: torch.Tensor, mask):
    x = arr.to(torch.float32)
    m = torch.isfinite(x) if mask is None else mask.expand(x.shape) & torch.isfinite(x)
    x = x.reshape(*x.shape[:-2], -1).contiguous()
    m = m.reshape(x.shape)
    n = m.to(torch.float32).sum(dim=-1)
    lo = torch.where(m, x, _BIG).amin(dim=-1)
    hi = torch.where(m, x, -_BIG).amax(dim=-1)
    return x, m, n, lo, hi


def _hist_bin(counts: torch.Tensor, target: torch.Tensor, bins: int) -> torch.Tensor:
    """The smallest bin whose count exceeds the target rank, as float32."""
    b = (counts <= target[..., None]).to(torch.int32).sum(dim=-1)
    return torch.clamp(b, 0, bins - 1).to(torch.float32)


def _hist_passes(x: torch.Tensor, m: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                 target: torch.Tensor, bins: int, passes: int):
    """``passes`` narrowings of each bracket [lo, hi] to the bin of ``bins``
    equal steps whose count of ``m`` elements of ``x`` <= its upper edge
    first exceeds the target rank."""
    steps = torch.arange(1, bins + 1, dtype=torch.float32, device=x.device)
    for _ in range(passes):
        span = torch.clamp(hi - lo, min=1e-30)
        edges = lo[..., None] + span[..., None] * steps / bins
        b = _hist_bin(_hist_counts(x, m, edges), target, bins)
        lo, hi = lo + span * b / bins, lo + span * (b + 1.0) / bins
    return lo, hi


def masked_percentile_hist(arr: torch.Tensor, mask, q: float, bins: int = 128,
                           refine: int = 2, fallback: float = 0.0) -> torch.Tensor:
    """The JAX ``masked_percentile_hist``: a bracket [lo, hi] from the masked
    range narrowed ``1 + refine`` times to the bin of ``bins`` equal steps
    whose count of elements <= its upper edge first exceeds the target rank
    q / 100 * (n - 1); the bracket's midpoint, ``fallback`` where the mask
    is empty.  Scalar ``q``; over the trailing (H, W) dimensions."""
    x, m, n, lo, hi = _hist_setup(arr, mask)
    # q / 100 as XLA compiles it: q times the float32 reciprocal of 100
    target = float(np.float32(q) * (np.float32(1.0) / np.float32(100.0))) \
        * torch.clamp(n - 1.0, min=0.0)
    lo, hi = _hist_passes(x, m, lo, hi, target, bins, 1 + refine)
    return torch.where(n > 0, 0.5 * (lo + hi), float(fallback))


def _fractions(qs: tuple, device) -> torch.Tensor:
    """float32(q / 100) for each of ``qs``, made on ``device`` by fills
    rather than copied from the host (a CUDA graph cannot capture the copy)."""
    return torch.stack([torch.full((), q / 100.0, dtype=torch.float32, device=device)
                        for q in qs])


def masked_percentile_hist_multi(arr: torch.Tensor, mask, qs: tuple, bins: int = 128,
                                 refine: int = 2, fallback: float = 0.0) -> torch.Tensor:
    """The JAX ``masked_percentile_hist_multi``: ``masked_percentile_hist``
    for each of ``qs`` with a shared first pass over the masked range
    (targets float32(q / 100) * (n - 1)); returns (..., Q)."""
    x, m, n, glo, ghi = _hist_setup(arr, mask)
    targets = _fractions(qs, x.device) * torch.clamp(n - 1.0, min=0.0)[..., None]
    steps = torch.arange(1, bins + 1, dtype=torch.float32, device=x.device)
    span = torch.clamp(ghi - glo, min=1e-30)
    counts = _hist_counts(x, m, glo[..., None] + span[..., None] * steps / bins)
    b = _hist_bin(counts[..., None, :], targets, bins)
    lo = glo[..., None] + span[..., None] * b / bins
    hi = glo[..., None] + span[..., None] * (b + 1.0) / bins
    rows = (*x.shape[:-1], len(qs), x.shape[-1])
    lo, hi = _hist_passes(x[..., None, :].expand(rows).contiguous(),
                          m[..., None, :].expand(rows), lo, hi, targets, bins, refine)
    return torch.where((n > 0)[..., None], 0.5 * (lo + hi), float(fallback))


def masked_percentile_hist_rows(X: torch.Tensor, M: torch.Tensor, qs: tuple, bins: int = 128,
                                refine: int = 2, fallback: float = 0.0) -> torch.Tensor:
    """The JAX ``masked_percentile_hist_rows``: (..., K, N) rows ``X`` under
    (..., K, N) masks ``M``, one quantile of ``qs`` per row, each row's
    bracket narrowed ``1 + refine`` times as ``masked_percentile_hist``
    narrows it, with the targets float32(q / 100) * (n - 1) of
    ``_hist_multi``; returns (..., K), ``fallback`` for an empty row."""
    if len(qs) != X.shape[-2]:
        raise ValueError(f"{len(qs)} quantiles for {X.shape[-2]} rows")
    x = X.to(torch.float32).contiguous()
    m = M.expand(x.shape) & torch.isfinite(x)
    n = m.to(torch.float32).sum(dim=-1)
    lo = torch.where(m, x, _BIG).amin(dim=-1)
    hi = torch.where(m, x, -_BIG).amax(dim=-1)
    targets = _fractions(qs, x.device) * torch.clamp(n - 1.0, min=0.0)
    lo, hi = _hist_passes(x, m, lo, hi, targets, bins, 1 + refine)
    return torch.where(n > 0, 0.5 * (lo + hi), float(fallback))


def get_percentile_fn(method: str):
    """``pctl(arr, mask, q)``: q a scalar gives (...,), a tuple (..., Q)."""
    if method == "sort":
        return masked_percentile
    if method == "hist":
        def hist(arr, mask, q, fallback=0.0):
            if isinstance(q, (tuple, list)):
                return masked_percentile_hist_multi(arr, mask, tuple(q), fallback=fallback)
            return masked_percentile_hist(arr, mask, q, fallback=fallback)
        return hist
    if method != "hist_pallas":
        raise ValueError(f"percentile method {method!r} is not ported "
                         "(plainref runs 'sort', 'hist' and 'hist_pallas')")

    def pctl(arr, mask, q):
        if isinstance(q, (tuple, list)):
            return masked_quantiles(arr, mask, tuple(q))
        return masked_quantiles(arr, mask, (q,))[..., 0]

    return pctl


def _valid(arr: torch.Tensor, mask: torch.Tensor):
    x = arr.to(torch.float32)
    return x, mask & torch.isfinite(x)


def masked_mean(arr: torch.Tensor, mask: torch.Tensor, fallback: float = 0.0,
                streams: bool = False) -> torch.Tensor:
    """Mean over the finite ``mask`` pixels, ``fallback`` where there are
    none (with ``streams``, arr's leading axis a batched forward's stream
    axis, the sum one call a stream, ``ops/streams.py``)."""
    x, m = _valid(arr, mask)
    n = m.sum(dim=(-2, -1)).to(torch.float32)
    s = each(lambda a: a.sum(dim=(-2, -1)), torch.where(m, x, 0.0), streams=streams)
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
