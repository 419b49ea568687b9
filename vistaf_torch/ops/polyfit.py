"""Robust masked 2-D polynomial fitting (JAX ``ops/polyfit.py``).

Routed by shape as the JAX package routes it on a TPU: the fused fit is the
K7 kernel (``kernels/polyfit_kernel.py``) while ``polyfit_kernel.fits``
holds; otherwise, and for ``fused=False``, the IRLS of the JAX
``_robust_polyfit2d_xla`` with the robust scale of its ``percentile_method``:
``hist_pallas`` takes the K2 median/MAD kernel
(``kernels/quantile_kernel.py``), ``hist`` two histogram percentiles
refined once, ``sort`` two sort percentiles.
"""
from __future__ import annotations

from typing import Tuple

import torch

from vistaf_torch.kernels import polyfit_kernel
from vistaf_torch.kernels.polyfit_kernel import basis, robust_polyfit2d_coef
from vistaf_torch.kernels.quantile_kernel import masked_median_mad
from vistaf_torch.ops.percentile import get_percentile_fn, masked_percentile_hist


def eval_poly2d(h: int, w: int, coef: torch.Tensor, order: int) -> torch.Tensor:
    cols = basis(h, w, 6 if order >= 2 else 3, coef.device)
    out = torch.zeros((h, w), dtype=torch.float32, device=coef.device)
    for i, col in enumerate(cols):
        out = out + coef[i] * col
    return out


def robust_polyfit2d_irls(z: torch.Tensor, mask: torch.Tensor, order: int = 2,
                          iters: int = 6, c: float = 4.685,
                          resigma_iters: int = 6,
                          percentile_method: str = "hist_pallas") -> torch.Tensor:
    """The non-fused IRLS on device tensors: ``iters`` solves of the
    w^2-weighted normal equations (``linalg.solve`` of H + 1e-9 I), the
    median/MAD of the residual in the first ``resigma_iters`` rounds (scale
    1.4826 (MAD + 1e-6); K2 for ``hist_pallas``, else the median of the
    residual and of its distance from that median by ``percentile_method``,
    ``hist`` refined once as in JAX) and Cauchy reweighting.  Returns the
    coefficients, zeros for masks under 200 px.  No host sync."""
    h, w = z.shape
    ncoef = 6 if order >= 2 else 3
    m = mask & torch.isfinite(z)
    mv = m.to(torch.float32).reshape(-1)
    zv = torch.where(m, z, 0.0).to(torch.float32).reshape(-1)
    B = torch.stack(basis(h, w, ncoef, z.device)).reshape(ncoef, -1)
    eye = 1e-9 * torch.eye(ncoef, dtype=torch.float32, device=z.device)
    wts = torch.ones_like(zv)
    coef = torch.zeros(ncoef, dtype=torch.float32, device=z.device)
    sigma = torch.tensor(1.0, device=z.device)
    if percentile_method == "hist":
        # the JAX IRLS refines the robust scale's brackets once, not twice
        pctl = lambda a, mm, q: masked_percentile_hist(a, mm, q, refine=1)  # noqa: E731
    else:
        pctl = None if percentile_method == "hist_pallas" else get_percentile_fn(percentile_method)
    for i in range(iters):
        w2 = (wts * mv) ** 2
        Bw = B * w2[None, :]
        coef = torch.linalg.solve_ex(Bw @ B.T + eye, Bw @ zv)[0]
        r = zv - coef @ B
        if i < resigma_iters:
            r2 = r.reshape(h, w)
            if pctl is None:
                mad = masked_median_mad(r2, m)[1]
            else:
                mad = pctl(torch.abs(r2 - pctl(r2, m, 50.0)), m, 50.0)
            sigma = 1.4826 * (mad + 1e-6)
        u = r / (c * sigma)
        wts = 1.0 / (1.0 + u * u)
    return torch.where(mv.sum() >= 200, coef, torch.zeros_like(coef))


def robust_polyfit2d(z: torch.Tensor, mask: torch.Tensor, order: int = 2,
                     iters: int = 6, c: float = 4.685, resigma_iters: int = 6,
                     fused: bool = True, percentile_method: str = "hist_pallas"
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """IRLS (Cauchy weights, w^2-weighted normal equations) fit of a plane
    or quadratic to ``z`` over ``mask``: returns (coef, fitted surface);
    zeros for masks under 200 px.  ``fused`` asks for the K7 whole-fit
    kernel, which runs while its budget holds; the IRLS otherwise takes its
    robust scale by ``percentile_method``."""
    if fused and polyfit_kernel.fits(z.shape):
        coef = robust_polyfit2d_coef(z, mask, order=order, iters=iters, c=c,
                                     resigma_iters=resigma_iters)
    else:
        coef = robust_polyfit2d_irls(z, mask, order=order, iters=iters, c=c,
                                     resigma_iters=resigma_iters,
                                     percentile_method=percentile_method)
    h, w = z.shape
    return coef, eval_poly2d(h, w, coef, order)
