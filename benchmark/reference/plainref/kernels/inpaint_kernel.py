"""K3: diffusion inpaint (``csrc/inpaint.cu``).

Replaces the JAX package's ``pallas/inpaint_kernel.py::inpaint_diffusion_pallas``
(the semantics of the JAX ``ops/inpaint.py::inpaint_diffusion_xla``):
unknown pixels start at the mean of the known ones, then ``iters`` Jacobi
steps of ``avg3(cur * w) / max(avg3(w), 1e-6)`` with an edge-replicate
border in the order (left + centre) + right, then (up + mid) + down;
``w <- min(w + [den > 1e-6], 1)``; known pixels stay clamped.

On the H100 (``csrc/inpaint.cu``'s note has the details) the function must
read the image and mask once and write the result, 24 MB at the 1608x1664
temperature crop, but each step needs its neighbours' previous state.  K3
tiles each plane into 32x64 outputs, one CTA each, stages
the tile and a 4-pixel halo of the state in shared memory and runs 4 steps
there before it writes the tile back, so a call is one launch of fixed-order
mean partials and ceil(iters / 4) step launches, enqueued by one C call and
counted as one launch.  Neighbour reads clamp to the plane, so every pixel
computes what the plain version computes from the same state, in the same
order: the kernel is bit-equal to it except in pixels that no step reaches,
which hold the initial mean.  That mean is a fixed-order two-stage sum (the
same bits on every run); it may differ from ``torch.sum``'s order by
rounding, within a relative 1e-6, and is exact on integer 0-255 data whose
sums stay below 2**24.
"""
from __future__ import annotations

import math

import torch

from plainref import kernels
from plainref.ops.padding import pad_last2

# the JAX package's _MAX_PADDED_ELEMS (pallas/inpaint_kernel.py:30)
_MAX_PADDED_ELEMS = 400_000


def fits(shape) -> bool:
    """The JAX package's ``fits_vmem`` (``pallas/inpaint_kernel.py:89``).
    Not a route: above it the JAX package runs the same stencil in XLA, so
    the port keeps the kernel at every size."""
    return kernels.padded_elems(shape) <= _MAX_PADDED_ELEMS


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
    batch = math.prod(x.shape[:-2])
    out = torch.empty_like(x)
    # one allocation: the f32 scratch (a state plane, the mean partials),
    # then two byte planes of w
    fbytes = 4 * kernels.library().vt_inpaint_scratch(batch, h, w)
    buf = torch.empty(fbytes + 2 * batch * h * w, dtype=torch.uint8, device=x.device)
    kernels.launch("vt_inpaint_diffusion", "inpaint_diffusion", x.device,
                   x.data_ptr(), fill.data_ptr(), out.data_ptr(), buf.data_ptr(),
                   buf[fbytes:].data_ptr(), batch, h, w, int(iters))
    return out
