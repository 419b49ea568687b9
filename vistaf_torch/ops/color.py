"""BGR -> gray and LAB chroma with OpenCV's 8-bit conventions (JAX
``ops/color.py``).  The LAB conversion itself lives in the fused
temperature kernel (``kernels/temp_kernel.py``), as in the deploy preset."""
from __future__ import annotations

import torch

# ITU-R BT.601 luma weights used by cv2.COLOR_BGR2GRAY.
_GRAY_W = (0.299, 0.587, 0.114)  # R, G, B


def bgr_to_gray(bgr: torch.Tensor) -> torch.Tensor:
    """BGR (..., H, W, 3) uint8/float -> float32 gray, rounded half to even
    like the reference's uint8 gray."""
    b = bgr[..., 0].float()
    g = bgr[..., 1].float()
    r = bgr[..., 2].float()
    y = _GRAY_W[0] * r + _GRAY_W[1] * g + _GRAY_W[2] * b
    return torch.round(y)


def chroma_ab(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """LAB chroma with OpenCV's +128 centering."""
    return torch.sqrt((a - 128.0) * (a - 128.0) + (b - 128.0) * (b - 128.0))
