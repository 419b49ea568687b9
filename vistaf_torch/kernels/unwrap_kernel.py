"""K6: the whole weighted-least-squares phase unwrap (``csrc/unwrap.cu``).

Replaces the JAX package's ``pallas/unwrap_kernel.py::unwrap_wls_pallas``, and
its plain version mirrors that Pallas body (not ``ops/unwrap.py``): on the
tile-padded domain ``pad_up(h, 8) x pad_up(w, 128)`` with zero weights in
the padding, binary edge weights, wrapped gradients in the real form
``x - 2pi * round(x / 2pi)``, the divergence, then a fixed trip of
``cg_iters`` PCG steps with the DCT-Poisson preconditioner
``Dh^T ((Dh r Dw^T) * inv_denom) Dw`` (``inv_denom`` 0 at DC), each step
kept only while ``sum(r*r) > tol^2 sum(r0*r0)`` (the ``live`` mask), then
the two-pass gauge on the masked mean and the congruence step; NaN off the
mask.  The plain version makes no host sync: the trip is fixed.

Routing (``kernels/__init__.py``): ``fits`` copies the JAX package's budget
(``unwrap_kernel.py:40-53``: padded elements and the DCT matrices' size);
above it ``unwrap_method='wls_pallas'`` takes the plain PCG of
``ops/unwrap.py``.

On the H100 the solve is ~2.1 GFLOP of dense DCT products at 240 x 256
(four per preconditioner application, 17 applications), too much for one
SM.  The kernel is a sequence of multi-CTA launches enqueued by one C call:
tiled FP32 FMA matrix products, stencil and update passes, and per-CTA
partial sums reduced in a fixed order by one warp that also forms alpha,
beta and ``live`` on the device.  No host sync inside the solve, no
atomics, no library matrix product.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from vistaf_torch import kernels
from vistaf_torch.ops.consts import DeviceConsts
from vistaf_torch.ops.unwrap import _dct2_matrix

# the JAX package's budget (pallas/unwrap_kernel.py:40-41)
_MAX_PADDED_ELEMS = 240_000
_MAX_DCT_ELEMS = 350_000
_TWO_PI = 2.0 * np.pi


def padded_shape(shape) -> Tuple[int, int]:
    return kernels.pad_up(shape[0], 8), kernels.pad_up(shape[1], 128)


def fits(shape) -> bool:
    """The JAX package's ``fits_vmem`` (``pallas/unwrap_kernel.py:47-53``)."""
    Hp, Wp = padded_shape(shape)
    return (kernels.padded_elems(shape) <= _MAX_PADDED_ELEMS
            and Hp * Hp + Wp * Wp <= _MAX_DCT_ELEMS)


def inv_poisson_denominator(Hp: int, Wp: int) -> np.ndarray:
    """1 / eigenvalue of the Neumann Laplacian on the padded grid, 0 at DC,
    in the Pallas wrapper's float32 arithmetic."""
    ky = np.pi * np.arange(Hp, dtype=np.float32)[:, None] / Hp
    kx = np.pi * np.arange(Wp, dtype=np.float32)[None, :] / Wp
    denom = 2.0 * (np.cos(ky) - 1.0) + 2.0 * (np.cos(kx) - 1.0)
    inv = np.where(np.abs(denom) < 1e-12, 0.0,
                   1.0 / np.where(np.abs(denom) < 1e-12, 1.0, denom)).astype(np.float32)
    inv[0, 0] = 0.0
    return inv


def _matrices(Hp: int, Wp: int, consts: DeviceConsts):
    """(Dh, Dh^T, Dw, Dw^T, inv_denom) on the consts' device, built once."""
    def dct(n, transpose):
        return consts.get(("dct_t" if transpose else "dct", n),
                          lambda: np.ascontiguousarray(_dct2_matrix(n).T) if transpose
                          else _dct2_matrix(n))
    return (dct(Hp, False), dct(Hp, True), dct(Wp, False), dct(Wp, True),
            consts.get(("inv_poisson_denom", Hp, Wp),
                       lambda: inv_poisson_denominator(Hp, Wp)))


def _wrap(x: torch.Tensor) -> torch.Tensor:
    return x - _TWO_PI * torch.round(x * (1.0 / _TWO_PI))


def _sh(a: torch.Tensor, k: int, axis: int) -> torch.Tensor:
    """a[v + k] along ``axis`` with a zero border (``pallas/common.py::shift_const0``)."""
    if k == 0:
        return a
    n = a.shape[axis]
    z = torch.zeros_like(a.narrow(axis, 0, abs(k)))
    if k > 0:
        return torch.cat([a.narrow(axis, k, n - k), z], dim=axis)
    return torch.cat([z, a.narrow(axis, 0, n + k)], dim=axis)


def _padded_inputs(wrapped: torch.Tensor, mask: torch.Tensor):
    h, w = wrapped.shape
    Hp, Wp = padded_shape((h, w))
    psi = F.pad(torch.where(mask, wrapped, 0.0).to(torch.float32), (0, Wp - w, 0, Hp - h))
    m = F.pad(mask.to(torch.float32), (0, Wp - w, 0, Hp - h))
    return psi, m


def unwrap_wls_plain(wrapped: torch.Tensor, mask: torch.Tensor, consts: DeviceConsts,
                     cg_iters: int = 30, tol: float = 1e-8) -> torch.Tensor:
    """Plain PyTorch version of K6, the Pallas body step for step."""
    h, w = wrapped.shape
    psi, m = _padded_inputs(wrapped, mask)
    Dh, DhT, Dw, DwT, inv_denom = _matrices(*psi.shape, consts)

    wx = m * _sh(m, 1, 1)
    wy = m * _sh(m, 1, 0)

    def div2(fx, fy):
        return (fx - _sh(fx, -1, 1)) + (fy - _sh(fy, -1, 0))

    def wlap(phi):
        return div2(wx * (_sh(phi, 1, 1) - phi), wy * (_sh(phi, 1, 0) - phi))

    def precond(r):
        t = (Dh @ r) @ DwT
        return (DhT @ (t * inv_denom)) @ Dw

    rhs = div2(_wrap(_sh(psi, 1, 1) - psi) * wx, _wrap(_sh(psi, 1, 0) - psi) * wy)
    phi = torch.zeros_like(psi)
    r = rhs
    z = precond(r)
    p = z
    rz = (r * z).sum()
    tol2r0 = (tol * tol) * (r * r).sum()
    for _ in range(cg_iters):
        live = (r * r).sum() > tol2r0
        Ap = wlap(p)
        pAp = (p * Ap).sum()
        alpha = rz / torch.where(torch.abs(pAp) < 1e-30, 1e-30, pAp)
        phi2 = phi + alpha * p
        r2 = r - alpha * Ap
        z2 = precond(r2)
        rz2 = (r2 * z2).sum()
        beta = rz2 / torch.where(torch.abs(rz) < 1e-30, 1e-30, rz)
        p2 = z2 + beta * p
        phi = torch.where(live, phi2, phi)
        r = torch.where(live, r2, r)
        p = torch.where(live, p2, p)
        rz = torch.where(live, rz2, rz)

    n = torch.clamp(m.sum(), min=1.0)
    d = psi - phi
    s1 = (d * m).sum() / n
    phi = phi + s1 + ((d - s1) * m).sum() / n
    k = torch.round((phi - psi) * (1.0 / _TWO_PI))
    phi = psi + _TWO_PI * k
    return torch.where(mask, phi[:h, :w], float("nan"))


def unwrap_wls(wrapped: torch.Tensor, mask: torch.Tensor, consts: DeviceConsts,
               cg_iters: int = 30, tol: float = 1e-8) -> torch.Tensor:
    """Congruent WLS unwrap of the (H, W) ``wrapped`` phase over ``mask``,
    anchored to its masked mean; NaN off the mask.  ``consts`` holds the
    DCT matrices on the tensors' device."""
    if kernels.route(wrapped) == "cpu":
        return unwrap_wls_plain(wrapped, mask, consts, cg_iters, tol)
    h, w = wrapped.shape
    msk = mask.to(torch.bool).contiguous()
    psi, m = _padded_inputs(wrapped, msk)
    kernels.check_cuda("unwrap_wls", psi, m, msk)
    Hp, Wp = psi.shape
    mats = _matrices(Hp, Wp, consts)
    out = torch.empty((h, w), dtype=torch.float32, device=psi.device)
    work = torch.empty(int(kernels.library().vt_unwrap_work_elems(Hp, Wp)),
                       dtype=torch.float32, device=psi.device)
    kernels.launch("vt_unwrap_wls", "unwrap_wls", psi.device,
                   psi.data_ptr(), m.data_ptr(), *(a.data_ptr() for a in mats),
                   msk.data_ptr(), out.data_ptr(), work.data_ptr(), h, w, Hp, Wp,
                   int(cg_iters), float(tol * tol))
    return out
