"""FTP complex demodulation of a frame pair (JAX ``ftp/demod.py``).

The port runs ``ftp_complex_demod_pair`` on its half-spectrum path
(``_demod_pair_rfft``): bad-pixel repair (K1 thresholds, K3 inpaint) and
illumination normalization batched over the pair, symmetric FFT padding,
``rfft2``, the carrier cascade on the reference half spectrum, parabolic
refinement, the Hermitian-extended sideband patch and its sparse inverse
DFT.  The full-``fft2`` pair path, the 'topk' carrier search, the Gaussian
sideband, unlocked per-frame demodulation and the Hann window are not
ported yet.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from vistaf_torch.config import FTPConfig
from vistaf_torch.ops import fftops
from vistaf_torch.ops.consts import DeviceConsts
from vistaf_torch.ops.filters import gaussian_blur, gradient_magnitude, hann_patch
from vistaf_torch.ops.inpaint import inpaint_diffusion
from vistaf_torch.ops.morphology import dilate, ellipse_kernel
from vistaf_torch.ops.padding import pad_last2
from vistaf_torch.ops.percentile import get_percentile_fn, masked_mean


class DemodResult(NamedTuple):
    complex_demod: torch.Tensor      # (h, w) complex64, carrier removed
    amp: torch.Tensor                # (h, w) float32 |complex_demod|
    peak_f: torch.Tensor             # (2,) refined peak (x, y) in bins
    k: torch.Tensor                  # (2,) carrier offset from DC (kx, ky)
    fft_shape: Tuple[int, int]       # (hf, wf)
    i_norm: torch.Tensor             # (h, w) normalized image


def check_config(cfg: FTPConfig) -> None:
    """Raise for a configuration whose demodulation is not ported."""
    if not (cfg.lock_carrier_to_reference and cfg.sideband_method == "patch_shift"
            and cfg.force_right_half_plane and cfg.peak_method == "cascade"):
        raise NotImplementedError(
            "vistaf_torch demodulates on the locked-carrier rfft2 pair path only "
            "(lock_carrier_to_reference, patch_shift, force_right_half_plane, "
            "peak_method='cascade')")
    if cfg.use_hann_window or not cfg.remove_mean_after_apod \
            or cfg.dc_remove_stat != "mean":
        raise NotImplementedError("vistaf_torch demodulation needs "
                                  "use_hann_window=False and dc_remove_stat='mean'")


def preprocess(gray: torch.Tensor, apo: Optional[torch.Tensor], cfg: FTPConfig,
               consts: DeviceConsts) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bad-pixel repair, illumination normalization and apodization of the
    (..., h, w) gray planes: returns (windowed image, I_norm)."""
    img = gray.to(torch.float32)
    valid = apo > 1e-6 if apo is not None else torch.ones_like(img[0], dtype=torch.bool)
    if cfg.bad_pixel_enable:
        pctl = get_percentile_fn(cfg.percentile_method)
        grad = gradient_magnitude(img)
        hi_thr = pctl(img, valid, cfg.bad_intensity_percentile)[..., None, None]
        g_thr = pctl(grad, valid, cfg.bad_gradient_percentile)[..., None, None]
        bad = ((img >= hi_thr) | (grad >= g_thr)) & valid
        if cfg.bad_dilate_ksize and cfg.bad_dilate_ksize > 1:
            ksz = max(3, cfg.bad_dilate_ksize | 1)
            bad = dilate(bad, ellipse_kernel(ksz, ksz), iterations=cfg.bad_dilate_iters)
        img = inpaint_diffusion(img, bad, iters=cfg.inpaint_iters)

    blur = gaussian_blur(img, cfg.illum_sigma_px, consts)
    i_norm = img / (blur + 1e-6) - 1.0
    if cfg.pre_blur_sigma_px and cfg.pre_blur_sigma_px > 0:
        i_norm = gaussian_blur(i_norm, cfg.pre_blur_sigma_px, consts)
    iw = i_norm * apo if apo is not None else i_norm
    iw = iw - masked_mean(iw, valid)[..., None, None]
    return iw, i_norm


def _demod_pair_rfft(iw_fft: torch.Tensor, i_norm_pair: torch.Tensor, h: int, w: int,
                     cfg: FTPConfig, consts: DeviceConsts
                     ) -> Tuple[DemodResult, DemodResult]:
    """Half-spectrum demodulation in the row-shifted rfft layout
    ``Rr[r, k] == F_shift[r, cx + k]``."""
    _, hf, wf = iw_fft.shape
    cy, cx = hf // 2, wf // 2
    pad = int(max(0, cfg.fft_pad_px))
    bw = int(max(3, cfg.patch_half_width_bins))
    psz = 2 * bw + 1

    Rr = torch.roll(torch.fft.rfft2(iw_fft), cy, dims=-2)
    mag_half = torch.abs(Rr[0])                         # (hf, cx + 1)
    kw = mag_half.shape[1]

    # carrier cascade over the half plane (the TPU graph's inline form)
    dc = int(cfg.dc_exclusion)
    iy = torch.arange(hf, device=Rr.device)[:, None]
    ik = torch.arange(kw, device=Rr.device)[None, :]
    notch = (ik < dc) & (iy >= cy - dc) & (iy < cy + dc)
    m1 = (~notch) & (ik >= 1)
    m2 = (m1 & (torch.abs(iy - cy) <= int(cfg.peak_max_dy_from_center * hf))
          if cfg.prefer_peak_near_center_row else m1)
    i2 = torch.argmax(torch.where(m2, mag_half, -3.0e38))
    i1 = torch.argmax(torch.where(m1, mag_half, -3.0e38))
    idx = torch.where(m2.any(), i2, i1)
    fx_h, fy = fftops.refine_peak_parabolic_log(mag_half, idx % kw, idx // kw)
    peak_f = torch.stack([fx_h + float(cx), fy])
    px_i = torch.round(peak_f[0]).to(torch.int64)
    py_i = torch.round(peak_f[1]).to(torch.int64)

    # Hermitian extension: bw negative-kx columns (mirror[r, k] = F_shift[r, cx - k])
    mirror = torch.conj(torch.roll(torch.flip(Rr, dims=(-2,)), 1, dims=-2))
    E = torch.cat([torch.flip(mirror[:, :, 1:bw + 1], dims=(-1,)), Rr], dim=-1)
    # dynamic_slice semantics: the window start is clamped into the array
    sy = torch.clamp(py_i - bw, 0, hf - psz)
    sx = torch.clamp(px_i - cx, 0, E.shape[-1] - psz)
    win = torch.arange(psz, device=Rr.device)
    patch = E.index_select(-2, sy + win).index_select(-1, sx + win)
    if cfg.patch_window == "hann":
        patch = patch * consts.get(("hann_patch", psz), lambda: hann_patch(psz, psz))
    field = fftops.ifft2_sparse_patch(patch, hf, wf, cy - psz // 2, cx - psz // 2, consts)
    dpx = peak_f[0] - px_i.to(torch.float32)
    dpy = peak_f[1] - py_i.to(torch.float32)
    field = field * fftops.frac_ramp(hf, wf, dpx, dpy, consts, sign=-1.0)

    if pad > 0:
        field = field[:, pad:pad + h, pad:pad + w]
    amp = torch.abs(field)
    k = torch.stack([peak_f[0] - cx, peak_f[1] - cy])
    return (DemodResult(field[0], amp[0], peak_f, k, (hf, wf), i_norm_pair[0]),
            DemodResult(field[1], amp[1], peak_f, k, (hf, wf), i_norm_pair[1]))


def ftp_complex_demod_pair(gray_ref: torch.Tensor, gray_def: torch.Tensor,
                           apo: Optional[torch.Tensor], cfg: FTPConfig,
                           consts: DeviceConsts) -> Tuple[DemodResult, DemodResult]:
    """Demodulate a reference/deformed pair with the carrier locked to the
    reference peak, every frame-independent stage batched over the pair."""
    check_config(cfg)
    h, w = gray_ref.shape
    iw_pair, i_norm_pair = preprocess(torch.stack([gray_ref, gray_def]), apo, cfg, consts)
    pad = int(max(0, cfg.fft_pad_px))
    iw_fft = pad_last2(iw_pair, (pad, pad, pad, pad), "symmetric") if pad > 0 else iw_pair
    hf, wf = iw_fft.shape[-2:]
    if hf % 2 or wf % 2 or min(hf, wf) < cfg.demod_rfft_min_px:
        raise NotImplementedError(f"padded FFT size {hf}x{wf}: the full-fft2 pair "
                                  "path is not ported (needs even sizes >= "
                                  "demod_rfft_min_px)")
    return _demod_pair_rfft(iw_fft, i_norm_pair, h, w, cfg, consts)
