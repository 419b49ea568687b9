"""Connected components (JAX ``ops/components.py``): neighbour-min label
propagation with pointer jumping, the largest component (the parity
preset's), the EDT-seeded dominant component (the deploy presets') and the
contact-blob peak filter.  Labels are root pixel indices (row-major
flat), background -1."""
from __future__ import annotations

import torch

from vistaf_torch.ops.distance import _shift2, distance_transform_edt
from vistaf_torch.ops.morphology import reconstruct

_BIG = 2147480000


def _neighbor_min(lab: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """8-connected neighbourhood minimum of the labels inside ``mask``."""
    lb = torch.where(mask, lab, _BIG)
    out = lb
    for dy, dx in ((-1, 0), (1, 0), (0, -1), (0, 1), (-1, -1), (-1, 1), (1, -1), (1, 1)):
        out = torch.minimum(out, _shift2(lb, dy, dx, _BIG))
    return torch.where(mask, out, _BIG)


def label(mask: torch.Tensor) -> torch.Tensor:
    """8-connected components: each True pixel gets the flat index of its
    component's root (minimum) pixel, False pixels -1.  Rounds of
    neighbour-min plus 8 pointer jumps, then a convergence check (one host
    sync per round)."""
    h, w = mask.shape
    n = h * w
    idx = torch.arange(n, device=mask.device, dtype=torch.int64).reshape(h, w)
    lab = torch.where(mask, idx, _BIG)
    while True:
        flat = _neighbor_min(lab, mask).reshape(-1)
        for _ in range(8):
            flat = torch.where(flat < n, flat[torch.clamp(flat, max=n - 1)], flat)
        new = flat.reshape(h, w)
        changed = bool((new != lab).any())
        lab = new
        if not changed:
            return torch.where(mask, lab, -1)


def component_areas(labels: torch.Tensor) -> torch.Tensor:
    """Areas keyed by root index (flat length h*w)."""
    flat = labels.reshape(-1)
    valid = flat >= 0
    key = torch.where(valid, flat, 0)
    return torch.zeros_like(flat).scatter_add(0, key, valid.to(flat.dtype))


def largest_component(mask: torch.Tensor) -> torch.Tensor:
    """The largest 8-connected component of ``mask`` (the first root in
    row-major order on a tie in area); an empty mask is returned as is."""
    labels = label(mask)
    best = torch.argmax(component_areas(labels))
    return torch.where(mask.any(), (labels == best) & mask, mask)


def dominant_component(mask: torch.Tensor, seed_pool: int = 1) -> torch.Tensor:
    """The component holding the mask's deepest interior point (EDT argmax,
    first maximum on ties), by geodesic reconstruction.  ``seed_pool`` > 1
    takes the seed from the EDT of the min-pooled mask, and falls back to
    the full-resolution seed when the pooled mask has no interior."""
    h, w = mask.shape
    if seed_pool > 1 and min(h, w) >= 8 * seed_pool:
        ds = int(seed_pool)
        hh, ww = (h // ds) * ds, (w // ds) * ds
        mp = mask[:hh, :ww].reshape(hh // ds, ds, ww // ds, ds).all(dim=3).all(dim=1)
        dist = distance_transform_edt(mp).reshape(-1)
        sf = torch.argmax(dist)
        sy = (sf // mp.shape[1]) * ds + ds // 2
        sx = (sf % mp.shape[1]) * ds + ds // 2
        yy = torch.arange(h, device=mask.device)[:, None]
        xx = torch.arange(w, device=mask.device)[None, :]
        seed = (yy == sy) & (xx == sx) & mask
        if bool(seed.any() & (dist[sf] > 0)):
            return reconstruct(seed, mask)
    return _dominant_component_fine(mask)


def _dominant_component_fine(mask: torch.Tensor) -> torch.Tensor:
    dist = distance_transform_edt(mask).reshape(-1)
    seed = torch.zeros_like(dist, dtype=torch.bool)
    seed[torch.argmax(dist)] = True
    return reconstruct(seed.reshape(mask.shape) & mask, mask)


def filter_components_by_peak(mask: torch.Tensor, values: torch.Tensor,
                              threshold: torch.Tensor,
                              min_area_px: int = 0) -> torch.Tensor:
    """Keep the components whose max of ``values`` is >= threshold (and whose
    area is >= min_area_px).  Without an area bound this is reconstruction
    from the deep-enough pixels; with one, labels and scatter reductions."""
    if not min_area_px or min_area_px <= 0:
        return reconstruct(mask & (values >= threshold), mask)
    labels = label(mask)
    flat = labels.reshape(-1)
    valid = flat >= 0
    key = torch.where(valid, flat, 0)
    v = torch.where(valid, values.reshape(-1).to(torch.float32), -3.0e38)
    peaks = torch.full(flat.shape, -3.0e38, dtype=torch.float32, device=flat.device)
    peaks = peaks.scatter_reduce(0, key, v, reduce="amax", include_self=True)
    keep = (peaks[key] >= threshold) & (component_areas(labels)[key] >= min_area_px)
    return (keep & valid).reshape(mask.shape)
