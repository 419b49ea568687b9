"""Image registration (JAX ``ops/registration.py``): cv2-style phase
correlation and the ECC alignment in cv2's translation, euclidean and affine
motion types.  The euclidean ECC with the shear sampler is routed by shape as
the JAX package routes it on a TPU: the whole-solve K5 kernel
(``kernels/ecc_loop_kernel.py``), else the per-iteration loop of K4
(``kernels/ecc_kernel.py``, the loop on the card), else the same loop over
the plain moments (``ecc_kernel.gn_loop``, a ``device_while``: a WHILE node
in a captured forward).  Every other solve is that loop over the plain
moments, as the JAX package runs plain XLA for it on a TPU: the shear
sampler in translation or affine mode (the stride folded into the mask), and
the bilinear-gather sampler (the parity preset's) in any mode, at a stride
on the subsampled grid.  Every route takes a stack of solves (``jax.vmap``
of ``ecc_align``), each solve bit for bit its own."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from plainref.kernels import ecc_kernel, ecc_loop_kernel
from plainref.kernels.ecc_loop_kernel import ecc_loop_euclidean
from plainref.ops.consts import DeviceConsts
from plainref.ops.streams import each
from plainref.ops.filters import gaussian_blur
from plainref.ops.warp import (sample_bilinear_stack, shear_warp_stack,
                                   warp_affine_inverse_map)


def phase_correlate(src1: torch.Tensor, src2: torch.Tensor, window: torch.Tensor,
                    streams: bool = False) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """cv2.phaseCorrelate: (dx, dy, response), the translation of ``src1``
    relative to ``src2``, from the whitened cross-power spectrum and a 5x5
    weighted centroid around the correlation peak: 0-d tensors for (H, W)
    planes, (...,) for (..., H, W) stacks.  With ``streams`` (the leading
    axis a batched forward's stream axis) the centroid's sums, and on the
    CPU the FFTs, run once a stream (``ops/streams.py``)."""
    h, w = src1.shape[-2:]
    a = src1.to(torch.float32) * window
    b = src2.to(torch.float32) * window
    F = each(torch.fft.rfft2, torch.stack([a, b], dim=-3), streams=streams, cpu_only=True)
    P = F[..., 0, :, :] * torch.conj(F[..., 1, :, :])
    P = P / torch.clamp(torch.abs(P), min=1e-20)
    C = torch.fft.fftshift(each(lambda q: torch.fft.irfft2(q, s=(h, w)), P, streams=streams,
                                cpu_only=True), dim=(-2, -1))
    peak = torch.argmax(C.flatten(-2), dim=-1)[..., None, None]
    py = peak // w
    px = peak % w
    yy = torch.arange(h, device=C.device)[:, None]
    xx = torch.arange(w, device=C.device)[None, :]
    inwin = ((torch.abs(yy - py) <= 2) & (torch.abs(xx - px) <= 2)).to(torch.float32)
    vals = C * inwin
    s, sy, sx = each(lambda v: (v.sum(dim=(-2, -1)), (yy.to(torch.float32) * v).sum(dim=(-2, -1)),
                                (xx.to(torch.float32) * v).sum(dim=(-2, -1))), vals,
                      streams=streams)
    den = torch.where(torch.abs(s) < 1e-20, 1.0, s)
    cy = sy / den
    cx = sx / den
    return w / 2.0 - cx, h / 2.0 - cy, s / (h * w)


# parameters per motion type (the JAX package's ``_MODES``); the affine
# vector is [a00 - 1, a10, a01, a11 - 1, tx, ty], column by column
ECC_MODES = {"translation": 2, "euclidean": 3, "affine": 6}


def warp_matrix(mode: str, p: torch.Tensor) -> torch.Tensor:
    """The (2, 3) inverse-map matrix of the warp parameters ``p``: [[cos t,
    -sin t, tx], [sin t, cos t, ty]] for the euclidean p = (t, tx, ty); a
    (..., P) stack of parameters gives (..., 2, 3)."""
    q = p.unbind(-1)

    def mat(r0, r1):
        return torch.stack([torch.stack(r0, dim=-1), torch.stack(r1, dim=-1)], dim=-2)

    if mode == "euclidean":
        c, s = torch.cos(q[0]), torch.sin(q[0])
        return mat([c, -s, q[1]], [s, c, q[2]])
    one, zero = torch.ones_like(q[0]), torch.zeros_like(q[0])
    if mode == "translation":
        return mat([one, zero, q[0]], [zero, one, q[1]])
    return mat([1.0 + q[0], q[2], q[4]], [q[1], 1.0 + q[3], q[5]])


def _warp_coords(mode: str, p: torch.Tensor, xx: torch.Tensor, yy: torch.Tensor):
    """(sx, sy) where W(x; p) samples the image, in the JAX package's term
    order; (..., h, w) each for a (..., P) stack of parameters."""
    p = [q[..., None, None] for q in p.unbind(-1)]
    if mode == "translation":
        return xx + p[0], yy + p[1]
    if mode == "euclidean":
        c, s = torch.cos(p[0]), torch.sin(p[0])
        return c * xx - s * yy + p[1], s * xx + c * yy + p[2]
    return (1.0 + p[0]) * xx + p[2] * yy + p[4], p[1] * xx + (1.0 + p[3]) * yy + p[5]


def _moment_matrix(mode: str, p: torch.Tensor, samp: torch.Tensor, mf: torch.Tensor,
                   T: torch.Tensor, xx: torch.Tensor, yy: torch.Tensor,
                   dtype=torch.float32) -> torch.Tensor:
    """Every Gauss-Newton statistic as an entry of A A^T, A the (3 + P, N)
    rows [m, T m, I m, G_1 .. G_P] of the sampled [I, gx, gy, ...] stack
    ``samp`` under the 0/1 mask ``mf``, G_k = gx dWx/dp_k + gy dWy/dp_k (the
    JAX ``_steepest_descent``), the product in ``dtype``.  A (..., C, h, w)
    stack with (..., P) parameters gives (..., 3 + P, 3 + P), the product
    once a solve (``ops/streams.py``)."""
    gxm = samp[..., 1, :, :] * mf
    gym = samp[..., 2, :, :] * mf
    if mode == "translation":
        G = [gxm, gym]
    elif mode == "euclidean":
        th = p[..., 0, None, None]
        c, s = torch.cos(th), torch.sin(th)
        G = [gxm * (-s * xx - c * yy) + gym * (c * xx - s * yy), gxm, gym]
    else:
        G = [gxm * xx, gym * xx, gxm * yy, gym * yy, gxm, gym]
    A = torch.stack([mf, T * mf, samp[..., 0, :, :] * mf] + G, dim=-3).reshape(
        *mf.shape[:-2], 3 + len(G), -1).to(dtype)
    return each(lambda a: a @ a.T, A, streams=A.dim() > 2)


def ecc_prepare(template: torch.Tensor, image: torch.Tensor, mask: torch.Tensor,
                streams: bool = False):
    """Centre both images on the template's masked mean and stack the
    image with its central-difference gradients and the mask:
    returns (S_cf (4, H, W) = [I, gx, gy, mask01], centred template); for
    (..., H, W) stacks, (..., 4, H, W) and (..., H, W).  With ``streams``
    (the leading axis a batched forward's stream axis) the mean's sum runs
    once a stream (``ops/streams.py``)."""
    T = template.to(torch.float32)
    I = image.to(torch.float32)
    M01 = mask.to(torch.float32)
    c0 = (each(lambda t, m: (t * m).sum(dim=(-2, -1)), T, M01.expand(T.shape),
               streams=streams) / torch.clamp(M01.sum(dim=(-2, -1)), min=1.0))[..., None, None]
    T = T - c0
    I = I - c0
    gx = torch.zeros_like(I)
    gx[..., :, 1:-1] = 0.5 * (I[..., :, 2:] - I[..., :, :-2])
    gy = torch.zeros_like(I)
    gy[..., 1:-1, :] = 0.5 * (I[..., 2:, :] - I[..., :-2, :])
    return torch.stack([I, gx, gy, M01.expand(I.shape)], dim=-3), T


def _grid(h: int, w: int, device, stride: int = 1):
    """(yy, xx) float32 pixel coordinates of the (h, w) plane, every
    ``stride``-th row and column."""
    yy = torch.arange(0, h, stride, dtype=torch.float32, device=device)
    xx = torch.arange(0, w, stride, dtype=torch.float32, device=device)
    return yy[:, None].expand(len(yy), len(xx)), xx[None, :].expand(len(yy), len(xx))


def _plain_moments(S_cf: torch.Tensor, T: torch.Tensor, sm: torch.Tensor, p: torch.Tensor,
                   K: int, mode: str = "euclidean") -> torch.Tensor:
    """The JAX package's XLA moments with the shear sampler (above K4's
    budget, or in translation or affine mode): the shear-sampled stack at
    W(p), the mask thresholded at 0.95 times the stride grid ``sm``, the
    steepest-descent rows and A A^T as one product."""
    samp = shear_warp_stack(S_cf, warp_matrix(mode, p), K=K)
    mf = (samp[..., 3, :, :] > 0.95).to(torch.float32) * sm
    yy, xx = _grid(*T.shape[-2:], T.device)
    return _moment_matrix(mode, p, samp, mf, T, xx, yy)


def _gather_moments(S_cf: torch.Tensor, T: torch.Tensor, p: torch.Tensor, xx: torch.Tensor,
                    yy: torch.Tensor, mode: str = "euclidean") -> torch.Tensor:
    """The JAX package's XLA moments with the bilinear-gather sampler: the
    [I, gx, gy, mask] stack sampled at W(x; p) on the statistics grid (xx,
    yy) (zeros outside), the template ``T`` on that grid, the mask
    thresholded at 0.95, the steepest-descent rows and A A^T as one product,
    accumulated in float64.

    Float64, where the JAX package sums in float32, as cv2's ECC (the
    reference's) accumulates its dot products and rho in double: the loop
    stops once rho moves by less than eps = 1e-7, and float32 sums over a
    full-resolution crop are noisier than that.  On the native-4K parity
    crop (1182^2) with float32 sums the card and the CPU stopped after 31
    and 14 iterations, 0.44 px apart in ty, a direction the synthetic
    grating leaves nearly flat."""
    sx, sy = _warp_coords(mode, p, xx, yy)
    samp = sample_bilinear_stack(S_cf, sy, sx)
    mf = (samp[..., 3, :, :] > 0.95).to(torch.float32)
    return _moment_matrix(mode, p, samp, mf, T, xx, yy, dtype=torch.float64)


def ecc_align(template: torch.Tensor, image: torch.Tensor, mask: torch.Tensor,
              mode: str = "euclidean", max_iters: int = 300, eps: float = 1e-7,
              stride: int = 1, sampler: str = "shear", shear_k: int = 4,
              stall_patience: int = 0, loop_kernel: bool = True,
              p_init: Optional[torch.Tensor] = None, streams: bool = False):
    """Warp maximizing the enhanced correlation coefficient between
    ``template`` and ``image`` sampled at W(x; p): returns (warp (2, 3),
    rho, n_iters).  On StsNoConv failure the warp is the identity and rho
    NaN, as the reference falls back to the unaligned image.  ``mode`` is
    cv2's motion type ('translation', 'euclidean' or 'affine'); ``stride``
    subsamples the statistics grid (the shear sampler folds it into the
    mask, the gather sampler samples the strided grid).  ``p_init`` (the
    mode's parameters) seeds the iteration instead of the identity; a seeded
    solve takes the per-iteration loop, as in the JAX package.  The defaults
    are the deploy route's (shear sampler, loop kernel); the JAX function
    defaults to the gather sampler without the loop kernel.

    (B, H, W) stacks of templates and images (one mask, or one a solve),
    with (B, P) seeds, are B solves, ``jax.vmap`` of this function, on every route: K5
    and K4 take the stack in one launch, the device loop runs while any
    solve is live (``ecc_kernel.gn_loop``); each solve keeps its own loop,
    stop and bits, giving (B, 2, 3), (B,) and (B,).  ``streams`` as in
    ``ecc_prepare``."""
    if mode not in ECC_MODES or sampler not in ("shear", "gather"):
        raise ValueError(f"ecc_align: unknown mode {mode!r} or sampler {sampler!r}")
    P = ECC_MODES[mode]
    S_cf, T = ecc_prepare(template, image, mask, streams=streams)
    lead = T.shape[:-2]
    p0 = (torch.zeros(*lead, P, dtype=torch.float32, device=T.device) if p_init is None
          else p_init.to(torch.float32).reshape(*lead, P))
    if sampler == "gather":
        yy, xx = _grid(*T.shape[-2:], T.device, stride)
        Ts = T[..., ::stride, ::stride]
        p, rho, it, failed = ecc_kernel.gn_loop(
            lambda q: _gather_moments(S_cf, Ts, q, xx, yy, mode), p0, max_iters, eps,
            stall_patience, dtype=torch.float64)
        return _result(mode, p, rho.to(torch.float32), it, failed)
    smask = torch.zeros(T.shape[-2:], dtype=T.dtype, device=T.device)
    smask[::stride, ::stride] = 1.0
    fused = mode == "euclidean" and ecc_kernel.fits(T.shape[-2:])
    if fused and loop_kernel and p_init is None and ecc_loop_kernel.fits(T.shape[-2:]):
        p, rho, it, failed = ecc_loop_euclidean(S_cf, T, smask, K=shear_k,
                                                max_iters=max_iters, eps=eps,
                                                stall_patience=stall_patience)
    elif fused:
        p, rho, it, failed = ecc_kernel.gn_loop_euclidean(
            S_cf, T, smask, p0, K=shear_k, max_iters=max_iters, eps=eps,
            stall_patience=stall_patience)
    else:
        p, rho, it, failed = ecc_kernel.gn_loop(
            lambda q: _plain_moments(S_cf, T, smask, q, shear_k, mode), p0, max_iters, eps,
            stall_patience)
    return _result(mode, p, rho, it, failed)


def _result(mode, p, rho, it, failed):
    """(warp, rho, n_iters): the identity and NaN rho on StsNoConv failure."""
    identity = warp_matrix(mode, torch.zeros_like(p))
    warp = torch.where(failed[..., None, None], identity, warp_matrix(mode, p))
    return warp, torch.where(failed, float("nan"), rho), it


def ecc_align_and_warp(ref: torch.Tensor, mov: torch.Tensor, mask: torch.Tensor,
                       consts: DeviceConsts, mode: str = "euclidean", max_iters: int = 300,
                       eps: float = 1e-7, gauss_filt: float = 5.0):
    """The reference's ``align_crop_ecc`` (the JAX ``ecc_align_and_warp``):
    both images scaled to [0, 1] and blurred by ``gauss_filt``, the gather
    ECC, then ``mov`` warped by the inverse map with the reflect border.
    Returns (aligned, warp, rho)."""
    r = ref.to(torch.float32) / 255.0
    m = mov.to(torch.float32) / 255.0
    if gauss_filt and gauss_filt > 0:
        r = gaussian_blur(r, gauss_filt, consts)
        m = gaussian_blur(m, gauss_filt, consts)
    warp, rho, _ = ecc_align(r, m, mask, mode=mode, max_iters=max_iters, eps=eps,
                             sampler="gather", loop_kernel=False)
    return warp_affine_inverse_map(mov.to(torch.float32), warp, border="reflect"), warp, rho
