"""Image registration (JAX ``ops/registration.py``): cv2-style phase
correlation and the ECC alignment in euclidean mode.  With the shear sampler
it is routed by shape as the JAX package routes it on a TPU: the whole-solve
K5 kernel (``kernels/ecc_loop_kernel.py``), else the per-iteration loop of K4
(``kernels/ecc_kernel.py``, the loop on the card), else the same loop on the
host with the plain moments.  With the bilinear-gather sampler (the parity
preset's, at stride 1) it is the host loop over the gather moments, as the
JAX package runs plain XLA for it on a TPU.  The translation and affine
modes are not ported yet."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from vistaf_torch.kernels import ecc_kernel, ecc_loop_kernel
from vistaf_torch.kernels.ecc_loop_kernel import ecc_loop_euclidean
from vistaf_torch.ops.warp import sample_bilinear_stack, shear_warp_stack


def phase_correlate(src1: torch.Tensor, src2: torch.Tensor, window: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """cv2.phaseCorrelate: (dx, dy, response), the translation of ``src1``
    relative to ``src2``, from the whitened cross-power spectrum and a 5x5
    weighted centroid around the correlation peak (0-d tensors)."""
    h, w = src1.shape
    a = src1.to(torch.float32) * window
    b = src2.to(torch.float32) * window
    F = torch.fft.rfft2(torch.stack([a, b]))
    P = F[0] * torch.conj(F[1])
    P = P / torch.clamp(torch.abs(P), min=1e-20)
    C = torch.fft.fftshift(torch.fft.irfft2(P, s=(h, w)))
    peak = torch.argmax(C)
    py = peak // w
    px = peak % w
    yy = torch.arange(h, device=C.device)[:, None]
    xx = torch.arange(w, device=C.device)[None, :]
    inwin = ((torch.abs(yy - py) <= 2) & (torch.abs(xx - px) <= 2)).to(torch.float32)
    vals = C * inwin
    s = vals.sum()
    den = torch.where(torch.abs(s) < 1e-20, 1.0, s)
    cy = (yy.to(torch.float32) * vals).sum() / den
    cx = (xx.to(torch.float32) * vals).sum() / den
    return w / 2.0 - cx, h / 2.0 - cy, s / (h * w)


def warp_matrix_euclidean(p: torch.Tensor) -> torch.Tensor:
    """[[cos t, -sin t, tx], [sin t, cos t, ty]] for p = (t, tx, ty)."""
    c, s = torch.cos(p[0]), torch.sin(p[0])
    return torch.stack([torch.stack([c, -s, p[1]]), torch.stack([s, c, p[2]])])


def ecc_prepare(template: torch.Tensor, image: torch.Tensor, mask: torch.Tensor):
    """Centre both images on the template's masked mean and stack the
    image with its central-difference gradients and the mask:
    returns (S_cf (4, H, W) = [I, gx, gy, mask01], centred template)."""
    T = template.to(torch.float32)
    I = image.to(torch.float32)
    M01 = mask.to(torch.float32)
    c0 = (T * M01).sum() / torch.clamp(M01.sum(), min=1.0)
    T = T - c0
    I = I - c0
    gx = torch.zeros_like(I)
    gx[:, 1:-1] = 0.5 * (I[:, 2:] - I[:, :-2])
    gy = torch.zeros_like(I)
    gy[1:-1, :] = 0.5 * (I[2:, :] - I[:-2, :])
    return torch.stack([I, gx, gy, M01]), T


def _plain_moments(S_cf: torch.Tensor, T: torch.Tensor, sm: torch.Tensor, p: torch.Tensor,
                   K: int) -> torch.Tensor:
    """The JAX package's XLA moments above K4's budget: the shear-sampled
    stack at W(p), the steepest-descent rows and A A^T as one product."""
    samp = shear_warp_stack(S_cf, warp_matrix_euclidean(p), K=K)
    mf = (samp[3] > 0.95).to(torch.float32) * sm
    gxm = samp[1] * mf
    gym = samp[2] * mf
    h, w = T.shape
    yy = torch.arange(h, dtype=torch.float32, device=T.device)[:, None].expand(h, w)
    xx = torch.arange(w, dtype=torch.float32, device=T.device)[None, :].expand(h, w)
    c, s = torch.cos(p[0]), torch.sin(p[0])
    g_theta = gxm * (-s * xx - c * yy) + gym * (c * xx - s * yy)
    A = torch.stack([mf, T * mf, samp[0] * mf, g_theta, gxm, gym]).reshape(6, -1)
    return A @ A.T


def _gather_moments(S_cf: torch.Tensor, T: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """The JAX package's XLA moments with the bilinear-gather sampler at
    stride 1: the [I, gx, gy, mask] stack sampled at the euclidean W(x; p)
    (zeros outside), the mask thresholded at 0.95, the steepest-descent rows
    and A A^T as one product, accumulated in float64.

    Float64, where the JAX package sums in float32, as cv2's ECC (the
    reference's) accumulates its dot products and rho in double: the loop
    stops once rho moves by less than eps = 1e-7, and float32 sums over a
    full-resolution crop are noisier than that.  On the native-4K parity
    crop (1182^2) with float32 sums the card and the CPU stopped after 31
    and 14 iterations, 0.44 px apart in ty, a direction the synthetic
    grating leaves nearly flat."""
    h, w = T.shape
    yy = torch.arange(h, dtype=torch.float32, device=T.device)[:, None].expand(h, w)
    xx = torch.arange(w, dtype=torch.float32, device=T.device)[None, :].expand(h, w)
    c, s = torch.cos(p[0]), torch.sin(p[0])
    samp = sample_bilinear_stack(S_cf, s * xx + c * yy + p[2], c * xx - s * yy + p[1])
    mf = (samp[3] > 0.95).to(torch.float32)
    gxm = samp[1] * mf
    gym = samp[2] * mf
    g_theta = gxm * (-s * xx - c * yy) + gym * (c * xx - s * yy)
    A = torch.stack([mf, T * mf, samp[0] * mf, g_theta, gxm, gym]).reshape(6, -1)
    A = A.to(torch.float64)
    return A @ A.T


def ecc_align(template: torch.Tensor, image: torch.Tensor, mask: torch.Tensor,
              mode: str = "euclidean", max_iters: int = 300, eps: float = 1e-7,
              stride: int = 1, sampler: str = "shear", shear_k: int = 4,
              stall_patience: int = 0, loop_kernel: bool = True,
              p_init: Optional[torch.Tensor] = None):
    """Warp maximizing the enhanced correlation coefficient between
    ``template`` and ``image`` sampled at W(x; p): returns (warp (2, 3),
    rho, n_iters).  On StsNoConv failure the warp is the identity and rho
    NaN, as the reference falls back to the unaligned image.  ``p_init``
    (theta, tx, ty) seeds the iteration instead of the identity; a seeded
    solve takes the per-iteration loop, as in the JAX package."""
    if mode != "euclidean" or sampler not in ("shear", "gather") \
            or (sampler == "gather" and stride != 1):
        raise NotImplementedError("vistaf_torch ports the euclidean ECC with the shear "
                                  "sampler or the gather sampler at stride 1, got "
                                  f"mode={mode!r}, sampler={sampler!r}, stride={stride}")
    S_cf, T = ecc_prepare(template, image, mask)
    p0 = (torch.zeros(3, dtype=torch.float32, device=T.device) if p_init is None
          else p_init.to(torch.float32).reshape(3))
    if sampler == "gather":
        p, rho, it, failed = ecc_kernel.gn_loop(lambda q: _gather_moments(S_cf, T, q), p0,
                                                max_iters, eps, stall_patience)
        return _result(p, rho.to(torch.float32), it, failed)
    smask = torch.zeros_like(T)
    smask[::stride, ::stride] = 1.0
    fused = ecc_kernel.fits(T.shape)
    if fused and loop_kernel and p_init is None and ecc_loop_kernel.fits(T.shape):
        p, rho, it, failed = ecc_loop_euclidean(S_cf, T, smask, K=shear_k,
                                                max_iters=max_iters, eps=eps,
                                                stall_patience=stall_patience)
    elif fused:
        p, rho, it, failed = ecc_kernel.gn_loop_euclidean(
            S_cf, T, smask, p0, K=shear_k, max_iters=max_iters, eps=eps,
            stall_patience=stall_patience)
    else:
        p, rho, it, failed = ecc_kernel.gn_loop(
            lambda q: _plain_moments(S_cf, T, smask, q, shear_k), p0, max_iters, eps,
            stall_patience)
    return _result(p, rho, it, failed)


def _result(p, rho, it, failed):
    """(warp, rho, n_iters): the identity and NaN rho on StsNoConv failure."""
    identity = warp_matrix_euclidean(torch.zeros_like(p))
    warp = torch.where(failed, identity, warp_matrix_euclidean(p))
    return warp, torch.where(failed, float("nan"), rho), it
