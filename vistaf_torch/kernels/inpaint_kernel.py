"""K3: diffusion inpaint (``csrc/inpaint.cu``).

Replaces the JAX package's ``pallas/inpaint_kernel.py::inpaint_diffusion_pallas``
(the semantics of the JAX ``ops/inpaint.py::inpaint_diffusion_xla``):
unknown pixels start at the mean of the known ones, then ``iters`` Jacobi
steps of ``avg3(cur * w) / max(avg3(w), 1e-6)`` with an edge-replicate
border in the order (left + centre) + right, then (up + mid) + down;
``w <- min(w + [den > 1e-6], 1)``; known pixels stay clamped.  On integer
0-255 data the initial mean is exact in any summation order, so kernel and
plain version agree to the last bit.

On the H100 one CTA per plane runs all steps, with a block barrier between
steps and the (cur, w) planes ping-ponging through L2: the kernel is bound
by one SM's L2 bandwidth and by barrier latency (20 steps at the slice).  A
later PR could keep a tile plus halo per CTA in shared memory and run the
steps across a cluster.
"""
from __future__ import annotations

import numpy as np
import torch

from vistaf_torch import kernels
from vistaf_torch.ops.padding import pad_last2


def _avg3(x: torch.Tensor) -> torch.Tensor:
    """3x3 box sum with an edge-replicate border, row sums first."""
    h, w = x.shape[-2:]
    xp = pad_last2(x, (1, 1, 1, 1), "replicate")
    rows = (xp[..., :, 0:w] + xp[..., :, 1:w + 1]) + xp[..., :, 2:w + 2]
    return (rows[..., 0:h, :] + rows[..., 1:h + 1, :]) + rows[..., 2:h + 2, :]


def inpaint_diffusion_plain(img: torch.Tensor, fill_mask: torch.Tensor,
                            iters: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel on (..., H, W) planes."""
    x = img.to(torch.float32)
    known = ~fill_mask
    kf = known.to(torch.float32)
    mean0 = (torch.where(known, x, 0.0).sum(dim=(-2, -1), keepdim=True)
             / torch.clamp(kf.sum(dim=(-2, -1), keepdim=True), min=1.0))
    cur = torch.where(known, x, mean0)
    w = kf
    for _ in range(iters):
        num = _avg3(cur * w)
        den = _avg3(w)
        grow = den > 1e-6
        upd = num / torch.clamp(den, min=1e-6)
        w = torch.clamp(w + grow.to(torch.float32), max=1.0)
        cur = torch.where(known, x, torch.where(grow, upd, cur))
    return cur


def inpaint_diffusion(img: torch.Tensor, fill_mask: torch.Tensor,
                      iters: int) -> torch.Tensor:
    """Fill the ``fill_mask`` pixels of the trailing (H, W) planes of
    ``img`` by diffusion from the rest; returns float32 of ``img``'s shape."""
    if kernels.route(img) == "cpu":
        return inpaint_diffusion_plain(img, fill_mask, iters)
    x = img.to(torch.float32).contiguous()
    fill = fill_mask.to(torch.bool).expand(x.shape).contiguous()
    kernels.check_cuda("inpaint_diffusion", x, fill)
    h, w = x.shape[-2:]
    batch = int(np.prod(x.shape[:-2])) if x.dim() > 2 else 1
    out = torch.empty_like(x)
    scratch = torch.empty((batch, 3, h, w), dtype=torch.float32, device=x.device)
    kernels.launch("vt_inpaint_diffusion", "inpaint_diffusion", x.device,
                   x.data_ptr(), fill.data_ptr(), out.data_ptr(), scratch.data_ptr(),
                   batch, h, w, int(iters))
    return out
