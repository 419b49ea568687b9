"""K7: the whole robust 2-D polynomial fit (``csrc/polyfit.cu``).

Replaces the JAX package's ``pallas/polyfit_kernel.py::robust_polyfit2d_pallas``:
``iters`` IRLS rounds, each the w^2-weighted normal equations as plane sums
(+1e-9 on the diagonal), an unrolled Cholesky solve, the residual, and in
the first ``resigma_iters`` rounds the bisection median/MAD (``LEVELS``,
16 levels each) of the residual; then Cauchy weights 1 / (1 + u^2) with
u = r / (c * 1.4826 * (mad + 1e-6)).  Zeros when the mask holds fewer than
200 pixels.  Returns the coefficients; ``eval_poly2d`` runs outside.

On the H100 the fit runs on one thread-block cluster of 8 CTAs that holds
the plane in shared memory for the whole fit (at most 150 KB a CTA inside
``fits``): each plane-wide total (a round's 27 sums, the residual's range, 8
bisection levels of leaf counts on the ladder of ``csrc/ladder.cuh``) is one
exchange through distributed shared memory, combined in rank order so that
every CTA holds the same bits.  One launch; the median/MAD are bit-equal to
``median_mad_rows`` on the same residuals.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from plainref import kernels
from plainref.kernels.quantile_kernel import bisect_levels, median_mad_rows

LEVELS = bisect_levels(128, 1)
_f32 = np.float32
# the JAX package's _MAX_PADDED_ELEMS (pallas/polyfit_kernel.py:32)
_MAX_PADDED_ELEMS = 300_000


def fits(shape) -> bool:
    """The JAX package's ``fits_vmem`` (``pallas/polyfit_kernel.py:38``):
    above it the fit is the IRLS with K2 (``ops/polyfit.py``)."""
    return kernels.padded_elems(shape) <= _MAX_PADDED_ELEMS


def basis(h: int, w: int, ncoef: int, device) -> List[torch.Tensor]:
    """[xn, yn, 1] (+ [xn^2, xn*yn, yn^2]) on the (h, w) grid, coordinates
    normalized to [-1, 1]."""
    yy = torch.arange(h, dtype=torch.float32, device=device)[:, None].expand(h, w)
    xx = torch.arange(w, dtype=torch.float32, device=device)[None, :].expand(h, w)
    cx, cy = (w - 1) / 2.0, (h - 1) / 2.0
    xn = (xx - cx) / cx
    yn = (yy - cy) / cy
    cols = [xn, yn, torch.ones_like(xn)]
    if ncoef == 6:
        cols += [xn * xn, xn * yn, yn * yn]
    return cols


def _chol_solve(H, g, n):
    """x = H^-1 g for symmetric positive definite H ({(i <= j): f32}),
    unrolled Cholesky and two substitutions, float32 scalars."""
    L = {}
    for j in range(n):
        s = H[(j, j)]
        for k in range(j):
            s = s - L[(j, k)] * L[(j, k)]
        L[(j, j)] = np.sqrt(np.maximum(s, _f32(1e-20)))
        for i in range(j + 1, n):
            t = H[(j, i)]
            for k in range(j):
                t = t - L[(i, k)] * L[(j, k)]
            L[(i, j)] = t / L[(j, j)]
    y = [None] * n
    for i in range(n):
        t = g[i]
        for k in range(i):
            t = t - L[(i, k)] * y[k]
        y[i] = t / L[(i, i)]
    x = [None] * n
    for i in reversed(range(n)):
        t = y[i]
        for k in range(i + 1, n):
            t = t - L[(k, i)] * x[k]
        x[i] = t / L[(i, i)]
    return x


def _median_mad(r: torch.Tensor, m: torch.Tensor, n: torch.Tensor):
    lo0 = torch.where(m, r, 3.0e38).amin()
    hi0 = torch.where(m, r, -3.0e38).amax()
    xs = torch.where(m, r, float("nan")).reshape(1, -1)
    med, mad = median_mad_rows(xs, n.reshape(1), lo0.reshape(1), hi0.reshape(1), LEVELS)
    return med[0], mad[0]


def robust_polyfit2d_coef_plain(z: torch.Tensor, mask: torch.Tensor, order: int = 2,
                                iters: int = 6, c: float = 4.685,
                                resigma_iters: int = 6) -> torch.Tensor:
    """Plain version: plane sums in PyTorch, the 6x6 solve on the host in
    float32 (one device-to-host copy per round)."""
    h, w = z.shape
    ncoef = 6 if order >= 2 else 3
    m = mask & torch.isfinite(z)
    zz = torch.where(m, z, 0.0).to(torch.float32)
    mf = m.to(torch.float32)
    n = mf.sum()
    cols = basis(h, w, ncoef, z.device)
    wts = torch.ones_like(zz)
    coef = [_f32(0.0)] * ncoef
    sigma = _f32(1.0)
    pairs = [(a, b) for a in range(ncoef) for b in range(a, ncoef)]
    for i in range(iters):
        wm = wts * mf
        w2 = wm * wm
        wc = [w2 * col for col in cols]
        sums = torch.stack([(wc[a] * cols[b]).sum() for a, b in pairs]
                           + [(wc[a] * zz).sum() for a in range(ncoef)]).cpu().numpy()
        H = {ab: sums[q] for q, ab in enumerate(pairs)}
        for a in range(ncoef):
            H[(a, a)] = H[(a, a)] + _f32(1e-9)
        coef = _chol_solve(H, sums[len(pairs):], ncoef)
        r = zz
        for a in range(ncoef):
            r = r - float(coef[a]) * cols[a]
        if i < resigma_iters:
            _med, mad = _median_mad(r, m, n)
            sigma = _f32(1.4826) * (_f32(mad.item()) + _f32(1e-6))
        u = r / float(_f32(c) * sigma)
        wts = 1.0 / (1.0 + u * u)
    out = torch.tensor(np.asarray(coef, np.float32), device=z.device)
    return torch.where(n >= 200.0, out, 0.0)


def robust_polyfit2d_coef_batched_plain(z: torch.Tensor, mask: torch.Tensor,
                                        order: int = 2, iters: int = 6, c: float = 4.685,
                                        resigma_iters: int = 6) -> torch.Tensor:
    """Plain version of a (..., H, W) stack of fits: each plane through
    ``robust_polyfit2d_coef_plain``, stacked to (..., ncoef)."""
    h, w = z.shape[-2:]
    m = mask.expand(z.shape).reshape(-1, h, w)
    coefs = [robust_polyfit2d_coef_plain(zp, mp, order, iters, c, resigma_iters)
             for zp, mp in zip(z.reshape(-1, h, w), m)]
    return torch.stack(coefs).reshape(*z.shape[:-2], -1)


def robust_polyfit2d_coef(z: torch.Tensor, mask: torch.Tensor, order: int = 2,
                          iters: int = 6, c: float = 4.685,
                          resigma_iters: int = 6) -> torch.Tensor:
    """IRLS coefficients of a plane (order 1, 3 coefficients) or quadratic
    (order 2, 6 coefficients) fit to the (H, W) plane ``z`` over ``mask``;
    a (..., H, W) stack is one fit a plane, (..., ncoef), in one launch."""
    if kernels.route(z) == "cpu":
        return robust_polyfit2d_coef_batched_plain(z, mask, order, iters, c, resigma_iters)
    zz = z.to(torch.float32).contiguous()
    m = mask.to(torch.bool).expand(zz.shape).contiguous()
    kernels.check_cuda("robust_polyfit2d", zz, m)
    if zz.dim() < 2:
        raise ValueError(f"robust_polyfit2d: shapes {tuple(zz.shape)}, {tuple(m.shape)}")
    if not fits(zz.shape[-2:]):
        raise ValueError(f"robust_polyfit2d: plane {tuple(zz.shape[-2:])} is above the "
                         f"kernel's budget of {_MAX_PADDED_ELEMS} padded elements")
    ncoef = 6 if order >= 2 else 3
    h, w = zz.shape[-2:]
    lead = zz.shape[:-2]
    planes = int(np.prod(lead, dtype=np.int64))
    out = torch.empty((*lead, ncoef), dtype=torch.float32, device=zz.device)
    kernels.launch("vt_robust_polyfit2d", "robust_polyfit2d", zz.device,
                   zz.data_ptr(), m.data_ptr(), out.data_ptr(), planes, h, w, ncoef,
                   int(iters), int(resigma_iters), float(c), LEVELS)
    return out
