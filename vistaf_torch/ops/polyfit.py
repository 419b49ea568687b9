"""Robust masked 2-D polynomial fitting (JAX ``ops/polyfit.py``).

The fit is the K7 kernel (``kernels/polyfit_kernel.py``, the JAX
``fused=True`` path); the non-fused XLA IRLS with its median/MAD kernel K2
is not ported yet.
"""
from __future__ import annotations

from typing import Tuple

import torch

from vistaf_torch.kernels.polyfit_kernel import basis, robust_polyfit2d_coef


def eval_poly2d(h: int, w: int, coef: torch.Tensor, order: int) -> torch.Tensor:
    cols = basis(h, w, 6 if order >= 2 else 3, coef.device)
    out = torch.zeros((h, w), dtype=torch.float32, device=coef.device)
    for i, col in enumerate(cols):
        out = out + coef[i] * col
    return out


def robust_polyfit2d(z: torch.Tensor, mask: torch.Tensor, order: int = 2,
                     iters: int = 6, c: float = 4.685,
                     resigma_iters: int = 6) -> Tuple[torch.Tensor, torch.Tensor]:
    """IRLS (Cauchy weights, w^2-weighted normal equations) fit of a plane
    or quadratic to ``z`` over ``mask``: returns (coef, fitted surface);
    zeros for masks under 200 px."""
    coef = robust_polyfit2d_coef(z, mask, order=order, iters=iters, c=c,
                                 resigma_iters=resigma_iters)
    h, w = z.shape
    return coef, eval_poly2d(h, w, coef, order)
