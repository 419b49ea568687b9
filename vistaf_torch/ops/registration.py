"""Image registration (JAX ``ops/registration.py``): cv2-style phase
correlation and the ECC alignment in euclidean mode with the shear sampler,
routed by shape as the JAX package routes it on a TPU: the whole-solve K5
kernel (``kernels/ecc_loop_kernel.py``), else the per-iteration loop with
the K4 moments (``kernels/ecc_kernel.py``), else with the plain moments.
The translation and affine modes and the bilinear-gather sampler are not
ported yet."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from vistaf_torch.kernels import ecc_kernel, ecc_loop_kernel
from vistaf_torch.kernels.ecc_loop_kernel import ecc_loop_euclidean
from vistaf_torch.ops.warp import shear_warp_stack


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


def _gn_loop(moments, p0: torch.Tensor, max_iters: int, eps: float,
             stall_patience: int):
    """The Gauss-Newton while loop of the JAX ``ecc_align`` on device
    tensors: ``linalg.solve`` of H + 1e-12 I for both right-hand sides, the
    lambda step, cv2's StsNoConv failure rule and, with
    ``stall_patience``, the best-rho iterate on a stall.  The loop condition
    costs one host sync per iteration."""
    dev = p0.device
    eye = 1e-12 * torch.eye(3, dtype=torch.float32, device=dev)
    p = p0
    last_rho = torch.tensor(-2.0, device=dev)
    rho = torch.tensor(-1.0, device=dev)
    failed = torch.tensor(False, device=dev)
    best_rho = torch.tensor(-2.0, device=dev)
    best_p = p0
    stall = torch.tensor(0, dtype=torch.int32, device=dev)
    it = 0

    def going() -> bool:
        go = (torch.abs(rho - last_rho) >= eps) & ~failed
        if stall_patience > 0:
            go = go & (stall < stall_patience)
        return bool(go)

    while it < max_iters and going():
        M = moments(p)
        n = torch.clamp(M[0, 0], min=1.0)
        st, si = M[0, 1], M[0, 2]
        sg = M[0, 3:]
        corr = M[1, 2] - st * si / n
        tnorm2 = M[1, 1] - st * st / n
        inorm2 = M[2, 2] - si * si / n
        Gt = M[1, 3:] - (st / n) * sg
        Gi = M[2, 3:] - (si / n) * sg
        UV = torch.linalg.solve_ex(M[3:, 3:] + eye, torch.stack([Gt, Gi], dim=1))[0]
        u, v1 = UV[:, 0], UV[:, 1]
        lam_num = inorm2 - Gi @ v1
        lam_den = corr - Gt @ v1
        lam = lam_num / torch.where(torch.abs(lam_den) < 1e-12, 1e-12, lam_den)
        p_new = p + (lam * u - v1)
        new_rho = corr / torch.clamp(torch.sqrt(torch.clamp(tnorm2, min=0.0)
                                                * torch.clamp(inorm2, min=0.0)), min=1e-12)
        now_failed = (lam_den <= 0.0) | torch.isnan(new_rho)
        p_new = torch.where(now_failed, p, p_new)
        improved = new_rho > best_rho
        best_rho = torch.where(improved, new_rho, best_rho)
        best_p = torch.where(improved, p, best_p)
        stall = torch.where(improved, 0, stall + 1)
        p, last_rho, rho = p_new, rho, new_rho
        failed = failed | now_failed
        it += 1
    if stall_patience > 0:
        stalled = stall >= stall_patience
        p = torch.where(stalled, best_p, p)
        rho = torch.where(stalled, best_rho, rho)
    return p, rho, torch.tensor(it, dtype=torch.int32, device=dev), failed


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
    if (mode, sampler) != ("euclidean", "shear"):
        raise NotImplementedError("vistaf_torch ports the euclidean/shear ECC only, "
                                  f"got mode={mode!r}, sampler={sampler!r}")
    S_cf, T = ecc_prepare(template, image, mask)
    smask = torch.zeros_like(T)
    smask[::stride, ::stride] = 1.0
    fused = ecc_kernel.fits(T.shape)
    if fused and loop_kernel and p_init is None and ecc_loop_kernel.fits(T.shape):
        p, rho, it, failed = ecc_loop_euclidean(S_cf, T, smask, K=shear_k,
                                                max_iters=max_iters, eps=eps,
                                                stall_patience=stall_patience)
    else:
        if fused:
            def moments(q):
                return ecc_kernel.gn_moments_euclidean(S_cf, T, smask,
                                                       ecc_kernel.shear_coeffs(q), K=shear_k)
        else:
            def moments(q):
                return _plain_moments(S_cf, T, smask, q, shear_k)
        p0 = (torch.zeros(3, dtype=torch.float32, device=T.device) if p_init is None
              else p_init.to(torch.float32).reshape(3))
        p, rho, it, failed = _gn_loop(moments, p0, max_iters, eps, stall_patience)
    identity = warp_matrix_euclidean(torch.zeros_like(p))
    warp = torch.where(failed, identity, warp_matrix_euclidean(p))
    rho = torch.where(failed, float("nan"), rho)
    return warp, rho, it
