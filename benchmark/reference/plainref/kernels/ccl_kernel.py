"""Connected-component labelling (``csrc/ccl.cu``).

Replaces no Pallas kernel: the JAX package labels with an XLA while loop
(``vistaf_tpu/ops/components.py::label``) inside its compiled forward.  The
plain version below is that loop, op for op; it tests convergence on the
host once a round.  The kernel computes the same labels (each foreground
pixel the flat row-major index of its 8-connected component's minimum
pixel, each background pixel -1) by union-find in three launches enqueued
by one C call, with no host read, so that the forward holding it can be
captured into one CUDA graph; ``LAUNCHES['label_components']`` counts the
call once.  Its parents only ever point to smaller indices and are linked
with integer ``atomicMin``, so each root is its component's minimum whatever
order the atomics land in: the kernel is bit-equal to the plain version.
"""
from __future__ import annotations

import torch

from plainref import kernels
from plainref.ops.distance import _shift2

_BIG = 2147480000


def _neighbor_min(lab: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """8-connected neighbourhood minimum of the labels inside ``mask``."""
    lb = torch.where(mask, lab, _BIG)
    out = lb
    for dy, dx in ((-1, 0), (1, 0), (0, -1), (0, 1), (-1, -1), (-1, 1), (1, -1), (1, 1)):
        out = torch.minimum(out, _shift2(lb, dy, dx, _BIG))
    return torch.where(mask, out, _BIG)


def label_components_plain(mask: torch.Tensor) -> torch.Tensor:
    """Plain version: rounds of neighbour-min plus 8 pointer jumps, then a
    convergence check (one host sync per round).  A (..., H, W) stack runs
    its planes together, each plane's pointers within it; a converged plane
    is a fixed point of a round, so each plane's labels are its own."""
    h, w = mask.shape[-2:]
    n = h * w
    idx = torch.arange(n, device=mask.device, dtype=torch.int64).reshape(h, w)
    lab = torch.where(mask, idx, _BIG)
    while True:
        flat = _neighbor_min(lab, mask).reshape(*mask.shape[:-2], n)
        for _ in range(8):
            flat = torch.where(flat < n, flat.gather(-1, torch.clamp(flat, max=n - 1)), flat)
        new = flat.reshape(mask.shape)
        changed = bool((new != lab).any())
        lab = new
        if not changed:
            return torch.where(mask, lab, -1)


def label_components(mask: torch.Tensor) -> torch.Tensor:
    """8-connected labels of the (..., H, W) boolean ``mask`` as int64: each
    True pixel the flat index (within its plane) of its component's minimum
    pixel, False pixels -1.  The planes of a stack are labelled in one call,
    on the card in the kernel's three launches with the planes on its grid."""
    if kernels.route(mask) == "cpu":
        return label_components_plain(mask)
    m = mask.to(torch.bool).contiguous()
    kernels.check_cuda("label_components", m)
    if m.dim() < 2 or m.numel() == 0 or m.shape[-2] * m.shape[-1] >= 2 ** 31:
        raise ValueError(f"label_components: non-empty (..., H, W) masks of fewer than "
                         f"2**31 pixels a plane, got {tuple(m.shape)}")
    h, w = m.shape[-2:]
    planes = m.numel() // (h * w)
    if planes > 65535:
        raise ValueError(f"label_components: {planes} planes, the grid holds 65535")
    parent = torch.empty(m.shape, dtype=torch.int32, device=m.device)
    out = torch.empty(m.shape, dtype=torch.int64, device=m.device)
    kernels.launch("vt_label_components", "label_components", m.device, m.data_ptr(),
                   parent.data_ptr(), out.data_ptr(), planes, h, w)
    return out
