"""Weighted least-squares phase unwrap (JAX ``ops/unwrap.py::unwrap_wls``):
PCG with a DCT-Poisson preconditioner (dense DCT matmuls at crop scale),
gauge anchoring and congruence projection.  The PCG ``while_loop`` is a
Python loop whose convergence check is one host sync per iteration.  The
``downsample`` path and the FFT-based DCT (both native-4K only) are not
ported yet."""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from vistaf_torch.ops.consts import DeviceConsts


def wrap_angle(x: torch.Tensor) -> torch.Tensor:
    """Wrap to (-pi, pi], angle(exp(i x))."""
    return torch.atan2(torch.sin(x), torch.cos(x))


def _dct2_matrix(n: int) -> np.ndarray:
    """Orthonormal DCT-II matrix: D @ x = dct(x, type=2, norm='ortho')."""
    k = np.arange(n)[:, None].astype(np.float64)
    x = np.arange(n)[None, :].astype(np.float64)
    D = np.cos(np.pi * (2.0 * x + 1.0) * k / (2.0 * n))
    D *= np.sqrt(2.0 / n)
    D[0] *= np.sqrt(0.5)
    return D.astype(np.float32)


def _poisson_denominator(h: int, w: int) -> np.ndarray:
    ky = np.float32(math.pi) * np.arange(h, dtype=np.float32)[:, None] / np.float32(h)
    kx = np.float32(math.pi) * np.arange(w, dtype=np.float32)[None, :] / np.float32(w)
    denom = (np.float32(2.0) * (np.cos(ky) - np.float32(1.0))
             + np.float32(2.0) * (np.cos(kx) - np.float32(1.0)))
    return np.where(np.abs(denom) < 1e-12, np.float32(1.0), denom).astype(np.float32)


def _poisson_dct_solve(rho: torch.Tensor, consts: DeviceConsts) -> torch.Tensor:
    """Neumann Poisson solve Laplacian(phi) = rho via DCT-II matmuls."""
    h, w = rho.shape
    Dh = consts.get(("dct", h), lambda: _dct2_matrix(h))
    Dw = consts.get(("dct", w), lambda: _dct2_matrix(w))
    denom = consts.get(("poisson_denom", h, w), lambda: _poisson_denominator(h, w))
    out = torch.matmul(torch.matmul(Dh, rho), Dw.T) / denom
    out[0, 0] = 0.0
    return torch.matmul(torch.matmul(Dh.T, out), Dw)


def _div2(fx: torch.Tensor, fy: torch.Tensor) -> torch.Tensor:
    """Divergence of edge fluxes with zero flux outside."""
    fxp = F.pad(fx, (1, 1))
    fyp = F.pad(fy, (0, 0, 1, 1))
    return (fxp[:, 1:] - fxp[:, :-1]) + (fyp[1:, :] - fyp[:-1, :])


def _apply_wlap(phi: torch.Tensor, wx: torch.Tensor, wy: torch.Tensor) -> torch.Tensor:
    return _div2(wx * (phi[:, 1:] - phi[:, :-1]), wy * (phi[1:, :] - phi[:-1, :]))


def _vdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a * b).sum()


def _wls_pcg_solve(psi: torch.Tensor, m: torch.Tensor, cg_iters: int, tol: float,
                   consts: DeviceConsts) -> torch.Tensor:
    wx = m[:, 1:] * m[:, :-1]
    wy = m[1:, :] * m[:-1, :]
    dx = wrap_angle(psi[:, 1:] - psi[:, :-1]) * wx
    dy = wrap_angle(psi[1:, :] - psi[:-1, :]) * wy
    rhs = _div2(dx, dy)
    phi = torch.zeros_like(psi)
    r = rhs - _apply_wlap(phi, wx, wy)
    z = _poisson_dct_solve(r, consts)
    p = z
    rz = _vdot(r, z)
    stop = tol * tol * _vdot(r, r)
    it = 0
    while it < cg_iters and bool(_vdot(r, r) > stop):
        Ap = _apply_wlap(p, wx, wy)
        pAp = _vdot(p, Ap)
        alpha = rz / torch.where(torch.abs(pAp) < 1e-30, 1e-30, pAp)
        phi = phi + alpha * p
        r = r - alpha * Ap
        z = _poisson_dct_solve(r, consts)
        rz_new = _vdot(r, z)
        beta = rz_new / torch.where(torch.abs(rz) < 1e-30, 1e-30, rz)
        p = z + beta * p
        rz = rz_new
        it += 1
    return phi


def _gauge_and_project(phi: torch.Tensor, psi: torch.Tensor, m: torch.Tensor,
                       mask: torch.Tensor) -> torch.Tensor:
    """Anchor phi to the wrapped input's masked mean (two-pass), snap to
    psi + 2 pi k (congruence), NaN outside the mask."""
    n = torch.clamp(m.sum(), min=1.0)
    d = psi - phi
    s1 = (d * m).sum() / n
    phi = phi + (s1 + ((d - s1) * m).sum() / n)
    two_pi = 2.0 * math.pi
    phi = psi + two_pi * torch.round((phi - psi) / two_pi)
    return torch.where(mask, phi, float("nan"))


def unwrap_wls(wrapped: torch.Tensor, mask: torch.Tensor, consts: DeviceConsts,
               cg_iters: int = 30, tol: float = 1e-8) -> torch.Tensor:
    """Weighted least-squares unwrap of ``wrapped`` over ``mask``, anchored
    to the wrapped input's masked mean and congruent with it; NaN outside
    the mask."""
    psi = torch.where(mask, wrapped, 0.0).to(torch.float32)
    m = mask.to(torch.float32)
    phi = _wls_pcg_solve(psi, m, cg_iters, tol, consts)
    return _gauge_and_project(phi, psi, m, mask)
