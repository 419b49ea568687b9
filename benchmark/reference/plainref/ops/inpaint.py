"""Diffusion inpainting (JAX ``ops/inpaint.py``).

The relaxation is the K3 kernel (``kernels/inpaint_kernel.py``) on a CUDA
tensor and its plain PyTorch version on a CPU tensor; ``inpaint_within_roi``
is the fill inside a region around it: in float for the force path's hole
fill (the parity preset's), through 8-bit levels for the temperature path.
``inpaint_float32`` is the reference's float fill (the median of the finite
values first); no pipeline reaches it.
"""
from __future__ import annotations

import math

import torch

from plainref.kernels.inpaint_kernel import inpaint_diffusion as _inpaint_kernel
from plainref.ops.percentile import masked_max, masked_median, masked_min


def inpaint_diffusion(img: torch.Tensor, fill_mask: torch.Tensor,
                      iters: int = 96) -> torch.Tensor:
    """Fill ``fill_mask`` pixels of the (..., H, W) planes by diffusing from
    the rest: known pixels stay clamped, unknown ones relax to the masked
    3x3 neighbourhood average."""
    return _inpaint_kernel(img, fill_mask, iters)


def inpaint_float32(img: torch.Tensor, bad_mask: torch.Tensor, iters: int = 64) -> torch.Tensor:
    """The reference's ``inpaint_float32``: non-finite values replaced by
    the median of the finite ones, then the ``bad_mask`` pixels filled."""
    x = img.to(torch.float32)
    finite = torch.isfinite(x)
    x = torch.where(finite, x, masked_median(x, finite))
    return inpaint_diffusion(x, bad_mask, iters=iters)


def inpaint_within_roi(z: torch.Tensor, roi: torch.Tensor, fill_mask: torch.Tensor,
                       iters: int = 96, quantize_u8: bool = False) -> torch.Tensor:
    """Inpaint only inside ``roi``; NaN outside; a degenerate range of the
    known values fills with its minimum.  With ``quantize_u8``, as the
    reference routes the temperature map through a uint8 image, the known
    values are scaled to [0, 255] over their range and rounded, filled,
    rounded and clipped again, and unscaled."""
    z = z.to(torch.float32)
    known = roi & torch.isfinite(z) & ~fill_mask
    missing = roi & fill_mask
    vmin = masked_min(z, known)[..., None, None]
    vmax = masked_max(z, known)[..., None, None]
    span = vmax - vmin
    if quantize_u8:
        scaled = torch.where(known, torch.clamp(
            (z - vmin) / torch.clamp(span, min=1e-6) * 255.0, 0.0, 255.0), 0.0)
        scaled = torch.round(scaled)
        filled = inpaint_diffusion(torch.where(known, scaled, 0.0), ~known, iters=iters)
        filled = torch.round(torch.clamp(filled, 0.0, 255.0))
        restored = filled / 255.0 * span + vmin
    else:
        restored = inpaint_diffusion(torch.where(known, z, 0.0), ~known, iters=iters)
    out = torch.where(known, z, torch.where(missing, restored, math.nan))
    out = torch.where(roi, out, math.nan)
    return torch.where(missing & (span < 1e-6), vmin, out)
