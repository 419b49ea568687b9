"""Connected components (JAX ``ops/components.py``): the labels, the
largest component (the parity preset's), the EDT-seeded dominant component
(the deploy presets') and the contact-blob peak filter.  Labels are root
pixel indices (row-major flat), background -1: on the card the labelling
kernel (``kernels/ccl_kernel.py``), on the CPU its plain version, the JAX
package's neighbour-min rounds.  Nothing here reads the device from the
host but ``device_if``'s plain form: the JAX package's ``lax.cond`` on the
pooled seed."""
from __future__ import annotations

import torch

from vistaf_torch.kernels.ccl_kernel import label_components
from vistaf_torch.ops.distance import distance_transform_edt
from vistaf_torch.ops.morphology import reconstruct
from vistaf_torch.utils.cuda_graph import device_if


def label(mask: torch.Tensor) -> torch.Tensor:
    """8-connected components: each True pixel gets the flat index of its
    component's root (minimum) pixel, False pixels -1; a (..., H, W) stack
    is labelled plane by plane."""
    return label_components(mask)


def component_areas(labels: torch.Tensor) -> torch.Tensor:
    """Areas keyed by root index (flat length h*w), (..., h*w) for a stack."""
    flat = labels.flatten(-2)
    valid = flat >= 0
    key = torch.where(valid, flat, 0)
    return torch.zeros_like(flat).scatter_add(-1, key, valid.to(flat.dtype))


def plane_any(x: torch.Tensor) -> torch.Tensor:
    """Whether each (..., H, W) plane holds a True, (..., 1, 1)."""
    return x.flatten(-2).any(dim=-1)[..., None, None]


def largest_component(mask: torch.Tensor) -> torch.Tensor:
    """The largest 8-connected component of ``mask`` (the first root in
    row-major order on a tie in area); an empty mask is returned as is."""
    labels = label(mask)
    best = torch.argmax(component_areas(labels), dim=-1)[..., None, None]
    return torch.where(plane_any(mask), (labels == best) & mask, mask)


def dominant_component(mask: torch.Tensor, seed_pool: int = 1) -> torch.Tensor:
    """The component holding the mask's deepest interior point (EDT argmax,
    first maximum on ties), by geodesic reconstruction.  ``seed_pool`` > 1
    takes the seed from the EDT of the min-pooled mask, and the
    full-resolution seed only where the pooled mask has no interior: the
    JAX package's ``lax.cond``, here a ``device_if`` (an IF node in a
    captured forward), so that the full-resolution transform runs only when
    the pooled seed fails.  For a (..., H, W) stack (``jax.vmap``, which
    batches the ``lax.cond`` into a select) the node runs when any plane's
    pooled seed fails, and each plane takes the full-resolution seed only
    where its own did."""
    h, w = mask.shape[-2:]
    if seed_pool > 1 and min(h, w) >= 8 * seed_pool:
        ds = int(seed_pool)
        hh, ww = (h // ds) * ds, (w // ds) * ds
        lead = mask.shape[:-2]
        mp = mask[..., :hh, :ww].reshape(*lead, hh // ds, ds, ww // ds, ds).all(
            dim=-1).all(dim=-2)
        dist = distance_transform_edt(mp).flatten(-2)
        sf = torch.argmax(dist, dim=-1)[..., None, None]
        sy = (sf // mp.shape[-1]) * ds + ds // 2
        sx = (sf % mp.shape[-1]) * ds + ds // 2
        yy = torch.arange(h, device=mask.device)[:, None]
        xx = torch.arange(w, device=mask.device)[None, :]
        seed = (yy == sy) & (xx == sx) & mask
        ok = seed.flatten(-2).any(dim=-1) & (dist.amax(dim=-1) > 0)   # dist[sf], the maximum
        fail = ~ok[..., None, None]
        device_if(fail.any(), lambda s: s.copy_(torch.where(fail, _fine_seed(mask), s)), seed,
                  site="seed")
    else:
        seed = _fine_seed(mask)
    return reconstruct(seed, mask)


def _fine_seed(mask: torch.Tensor) -> torch.Tensor:
    """The full-resolution seed: the mask's first EDT maximum."""
    dist = distance_transform_edt(mask).flatten(-2)
    flat = (torch.arange(dist.shape[-1], device=mask.device)
            == torch.argmax(dist, dim=-1, keepdim=True))
    return flat.reshape(mask.shape) & mask


def filter_components_by_peak(mask: torch.Tensor, values: torch.Tensor,
                              threshold: torch.Tensor,
                              min_area_px: int = 0) -> torch.Tensor:
    """Keep the components whose max of ``values`` is >= threshold (and whose
    area is >= min_area_px).  Without an area bound this is reconstruction
    from the deep-enough pixels; with one, labels and scatter reductions.
    A (..., H, W) stack takes (..., 1, 1) thresholds."""
    if not min_area_px or min_area_px <= 0:
        return reconstruct(mask & (values >= threshold), mask)
    labels = label(mask)
    flat = labels.flatten(-2)
    valid = flat >= 0
    key = torch.where(valid, flat, 0)
    v = torch.where(valid, values.flatten(-2).to(torch.float32), -3.0e38)
    peaks = torch.full(flat.shape, -3.0e38, dtype=torch.float32, device=flat.device)
    peaks = peaks.scatter_reduce(-1, key, v, reduce="amax", include_self=True)
    thr = threshold.flatten(-2) if threshold.dim() >= 2 else threshold
    keep = (peaks.gather(-1, key) >= thr) & (component_areas(labels).gather(-1, key)
                                              >= min_area_px)
    return (keep & valid).reshape(mask.shape)
