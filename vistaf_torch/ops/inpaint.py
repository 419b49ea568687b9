"""Diffusion inpainting (JAX ``ops/inpaint.py::inpaint_diffusion``).

The relaxation is the K3 kernel (``kernels/inpaint_kernel.py``) on a CUDA
tensor and its plain PyTorch version on a CPU tensor; ``inpaint_float32``
and ``inpaint_within_roi`` (the hole fill the deploy preset turns off) are
not ported yet.
"""
from __future__ import annotations

import torch

from vistaf_torch.kernels.inpaint_kernel import inpaint_diffusion as _inpaint_kernel


def inpaint_diffusion(img: torch.Tensor, fill_mask: torch.Tensor,
                      iters: int = 96) -> torch.Tensor:
    """Fill ``fill_mask`` pixels of the (..., H, W) planes by diffusing from
    the rest: known pixels stay clamped, unknown ones relax to the masked
    3x3 neighbourhood average."""
    return _inpaint_kernel(img, fill_mask, iters)
