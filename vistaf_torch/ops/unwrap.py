"""Weighted least-squares phase unwrap (JAX ``ops/unwrap.py::unwrap_wls``):
PCG with a DCT-Poisson preconditioner, gauge anchoring and congruence
projection, and the ``downsample`` path of the native-4K deploy preset (the
solve on a pooled grid, pooled in the complex domain, upsampled as
``jax.image.resize`` 'linear' does).  The orthonormal DCT-II is a pair of
dense matmuls below ``_DCT_FFT_MIN_PX`` and an FFT above it (Makhoul's
even/odd reordering, one complex FFT and a twiddle a transform, as the JAX
package's ``jax.scipy.fft.dct``; the full-resolution parity solve at native
4K takes it).  The PCG ``while_loop`` is a ``device_while``: a WHILE node in
a captured forward, else a loop whose condition is read on the host once an
iteration.  The K6 kernel
(``kernels/unwrap_kernel.py``) is the ``wls_pallas`` route.

A (B, H, W) stack is B solves, ``jax.vmap`` of ``unwrap_wls``: every op
runs once over the stack, the PCG loops while any solve is live and a trip
writes only the live solves' state; the plane sums, the dense DCT and
resize products and the FFT DCT run once a plane (``ops/streams.py``), so
each solve keeps its own bits."""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from vistaf_torch.ops.consts import DeviceConsts
from vistaf_torch.ops.streams import each, keep_live
from vistaf_torch.utils.cuda_graph import device_while


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


# the JAX package's switch to the FFT-based DCT (ops/unwrap.py:49)
_DCT_FFT_MIN_PX = 512


def dense_dct_solve(shape) -> bool:
    """Whether the JAX package solves an unwrap grid of ``shape`` with the
    dense DCT matrices (else with its FFT-based DCT)."""
    return min(shape) < _DCT_FFT_MIN_PX


def _dct_twiddle(n: int) -> np.ndarray:
    """2 f_k exp(-i pi k / (2n)): the twiddle of Makhoul's DCT-II times the
    orthonormal scale (f_0 = sqrt(1 / 4n), f_k = sqrt(1 / 2n))."""
    k = np.arange(n, dtype=np.float64)
    scale = np.full(n, 2.0 * np.sqrt(1.0 / (2.0 * n)))
    scale[0] = 2.0 * np.sqrt(1.0 / (4.0 * n))
    return (scale * np.exp(-1j * np.pi * k / (2.0 * n))).astype(np.complex64)


def _idct_twiddle(n: int) -> np.ndarray:
    """exp(i pi k / (2n)) / (2 f_k): the inverse's twiddle."""
    return (1.0 / _dct_twiddle(n).astype(np.complex128)).astype(np.complex64)


def dct_ortho(x: torch.Tensor, dim: int, consts: DeviceConsts) -> torch.Tensor:
    """``dct(x, type=2, norm='ortho', axis=dim)`` of a real tensor by one
    FFT: v = (x[0], x[2], ..., x[3], x[1]), X_k = Re(fft(v)_k 2 f_k
    exp(-i pi k / 2n))."""
    x = x.transpose(dim, -1)
    n = x.shape[-1]
    v = torch.cat([x[..., ::2], x[..., 1::2].flip(-1)], dim=-1)
    tw = consts.get(("dct_twiddle", n), lambda: _dct_twiddle(n))
    return (torch.fft.fft(v) * tw).real.transpose(dim, -1)


def idct_ortho(X: torch.Tensor, dim: int, consts: DeviceConsts) -> torch.Tensor:
    """The inverse of ``dct_ortho`` (``idct(X, type=2, norm='ortho')``): with
    Y_k = X_k / 2 f_k, fft(v)_k = (Y_k - i Y_{n-k}) exp(i pi k / 2n) (Y_n =
    0) is Hermitian, so v is one inverse real FFT of its first half; the
    even/odd reordering is then undone."""
    X = X.transpose(dim, -1)
    n = X.shape[-1]
    h = n // 2 + 1
    tw = consts.get(("idct_twiddle", n), lambda: _idct_twiddle(n))
    y_rev = torch.cat([torch.zeros_like(X[..., :1]), X[..., 1:].flip(-1)], dim=-1)
    V = torch.complex(X[..., :h], -y_rev[..., :h]) * tw[:h]
    v = torch.fft.irfft(V, n=n)
    x = torch.empty_like(X)
    ne = (n + 1) // 2
    x[..., ::2] = v[..., :ne]
    x[..., 1::2] = v[..., ne:].flip(-1)
    return x.transpose(dim, -1)


def _poisson_dct_solve(rho: torch.Tensor, consts: DeviceConsts) -> torch.Tensor:
    """Neumann Poisson solve Laplacian(phi) = rho via DCT-II: dense matmuls
    below ``_DCT_FFT_MIN_PX``, FFTs from it on; a (B, H, W) stack plane by
    plane (``ops/streams.py``)."""
    if rho.dim() > 2:
        return each(lambda r: _poisson_dct_solve(r, consts), rho, streams=True)
    h, w = rho.shape
    denom = consts.get(("poisson_denom", h, w), lambda: _poisson_denominator(h, w))
    if not dense_dct_solve((h, w)):
        out = dct_ortho(dct_ortho(rho, 0, consts), 1, consts) / denom
        out[0, 0].zero_()
        return idct_ortho(idct_ortho(out, 0, consts), 1, consts)
    Dh = consts.get(("dct", h), lambda: _dct2_matrix(h))
    Dw = consts.get(("dct", w), lambda: _dct2_matrix(w))
    out = torch.matmul(torch.matmul(Dh, rho), Dw.T) / denom
    out[0, 0].zero_()
    return torch.matmul(torch.matmul(Dh.T, out), Dw)


def _div2(fx: torch.Tensor, fy: torch.Tensor) -> torch.Tensor:
    """Divergence of edge fluxes with zero flux outside."""
    fxp = F.pad(fx, (1, 1))
    fyp = F.pad(fy, (0, 0, 1, 1))
    return (fxp[..., 1:] - fxp[..., :-1]) + (fyp[..., 1:, :] - fyp[..., :-1, :])


def _apply_wlap(phi: torch.Tensor, wx: torch.Tensor, wy: torch.Tensor) -> torch.Tensor:
    return _div2(wx * (phi[..., 1:] - phi[..., :-1]), wy * (phi[..., 1:, :] - phi[..., :-1, :]))


def _psum(x: torch.Tensor) -> torch.Tensor:
    """The sum of an (H, W) plane, 0-d; (B,) for a stack, plane by plane."""
    return each(torch.sum, x, streams=x.dim() > 2)


def _vdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _psum(a * b)


def _bc(x: torch.Tensor) -> torch.Tensor:
    """A 0-d or (B,) per-solve scalar against the (..., H, W) planes."""
    return x[..., None, None]


def _wls_pcg_solve(psi: torch.Tensor, m: torch.Tensor, cg_iters: int, tol: float,
                   consts: DeviceConsts) -> torch.Tensor:
    """The JAX ``lax.while_loop`` PCG as a ``device_while`` over the state
    (phi, r, p, rz, the int32 trip count), updated in place.  A (B, H, W)
    stack has a stop, rz and trip count a solve; the loop runs while any
    solve is live, and a trip writes only the live solves'."""
    batched = psi.dim() > 2
    wx = m[..., 1:] * m[..., :-1]
    wy = m[..., 1:, :] * m[..., :-1, :]
    dx = wrap_angle(psi[..., 1:] - psi[..., :-1]) * wx
    dy = wrap_angle(psi[..., 1:, :] - psi[..., :-1, :]) * wy
    rhs = _div2(dx, dy)
    phi = torch.zeros_like(psi)
    r = rhs - _apply_wlap(phi, wx, wy)
    z = _poisson_dct_solve(r, consts)
    p = z
    rz = _vdot(r, z)
    stop = tol * tol * _vdot(r, r)
    state = (phi, r, p, rz, torch.zeros(rz.shape, dtype=torch.int32, device=psi.device))

    def live(s):
        phi, r, p, rz, it = s
        return (it < cg_iters) & (_vdot(r, r) > stop)

    def body(s):
        phi, r, p, rz, it = s
        go = live(s) if batched else None

        def keep(new, old):   # only the live solves move
            return new if go is None else keep_live(go, new, old)

        Ap = _apply_wlap(p, wx, wy)
        pAp = _vdot(p, Ap)
        alpha = _bc(rz / torch.where(torch.abs(pAp) < 1e-30, 1e-30, pAp))
        phi.copy_(keep(phi + alpha * p, phi))
        r_new = r - alpha * Ap
        z = _poisson_dct_solve(r_new, consts)
        rz_new = _vdot(r_new, z)
        beta = _bc(rz_new / torch.where(torch.abs(rz) < 1e-30, 1e-30, rz))
        p.copy_(keep(z + beta * p, p))
        r.copy_(keep(r_new, r))
        rz.copy_(keep(rz_new, rz))
        it.add_(1 if go is None else go.to(torch.int32))

    device_while(lambda s: live(s).any() if batched else live(s), body, state, site="pcg")
    return phi


def _gauge_and_project(phi: torch.Tensor, psi: torch.Tensor, m: torch.Tensor,
                       mask: torch.Tensor) -> torch.Tensor:
    """Anchor phi to the wrapped input's masked mean (two-pass), snap to
    psi + 2 pi k (congruence), NaN outside the mask; a stack plane by plane."""
    n = torch.clamp(_psum(m), min=1.0)
    d = psi - phi
    s1 = _bc(_psum(d * m) / n)
    phi = phi + (s1 + _bc(_psum((d - s1) * m) / n))
    two_pi = 2.0 * math.pi
    phi = psi + two_pi * torch.round((phi - psi) / two_pi)
    return torch.where(mask, phi, float("nan"))


def _linear_upsample_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_in, n_out) weights of ``jax.image.resize(..., 'linear')`` along one
    axis (its ``compute_weight_mat`` for upsampling): half-pixel centres,
    triangle taps, weights renormalised where a tap falls off the edge."""
    scale = n_out / n_in
    inv_scale = np.float32(1.0 / scale)
    sample_f = ((np.arange(n_out, dtype=np.float32) + np.float32(0.5)) * inv_scale
                - np.float32(0.0) * inv_scale - np.float32(0.5))
    x = np.abs(sample_f[None, :] - np.arange(n_in, dtype=np.float32)[:, None])
    weights = np.maximum(np.float32(0.0), np.float32(1.0) - x)
    total = weights.sum(axis=0, keepdims=True, dtype=np.float32)
    weights = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                       weights / np.where(total != 0, total, np.float32(1.0)),
                       np.float32(0.0))
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return np.where(inside[None, :], weights, np.float32(0.0)).astype(np.float32)


def resize_linear(x: torch.Tensor, shape, consts: DeviceConsts) -> torch.Tensor:
    """``jax.image.resize(x, shape, 'linear')`` of an (h, w) plane for an
    upsample, as two weight-matrix products; a (B, h, w) stack plane by
    plane (``ops/streams.py``)."""
    (h, w), (H, W) = x.shape[-2:], shape
    Wy = consts.get(("resize_linear", h, H), lambda: _linear_upsample_matrix(h, H))
    Wx = consts.get(("resize_linear", w, W), lambda: _linear_upsample_matrix(w, W))
    return each(lambda a: Wy.T @ a @ Wx, x, streams=x.dim() > 2)


def unwrap_wls(wrapped: torch.Tensor, mask: torch.Tensor, consts: DeviceConsts,
               cg_iters: int = 30, tol: float = 1e-8, downsample: int = 1) -> torch.Tensor:
    """Weighted least-squares unwrap of ``wrapped`` over ``mask``, anchored
    to the wrapped input's masked mean and congruent with it; NaN outside
    the mask.  ``downsample=d`` solves on the d x d sum-pooled grid (the
    wrapped phase pooled as the angle of the masked phasor sum) and
    upsamples the smooth solution before the full-resolution gauge and
    congruence step.  A (B, H, W) stack is B solves (``jax.vmap``)."""
    psi = torch.where(mask, wrapped, 0.0).to(torch.float32)
    m = mask.to(torch.float32)
    if downsample > 1:
        d = int(downsample)
        h, w = psi.shape[-2:]
        Hp, Wp = -(-h // d) * d, -(-w // d) * d

        def pool(a):
            return each(lambda x: F.pad(x, (0, Wp - w, 0, Hp - h)).reshape(
                Hp // d, d, Wp // d, d).sum(dim=(1, 3)), a, streams=a.dim() > 2)

        zr, zi = pool(torch.cos(psi) * m), pool(torch.sin(psi) * m)
        mc = pool(m)
        psi_c = torch.atan2(zi, zr)
        phi_c = _wls_pcg_solve(torch.where(mc > 0, psi_c, 0.0), (mc > 0).to(torch.float32),
                               cg_iters, tol, consts)
        phi = resize_linear(phi_c, (Hp, Wp), consts)[..., :h, :w]
    else:
        phi = _wls_pcg_solve(psi, m, cg_iters, tol, consts)
    return _gauge_and_project(phi, psi, m, mask)
