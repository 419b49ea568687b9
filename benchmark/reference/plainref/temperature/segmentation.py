"""Periodic TLC-stripe segmentation by FFT carrier extraction (JAX
``temperature/segmentation.py``), on every route of its knobs: the deploy
route (the rfft2 half spectrum, the masked-argmax carrier cascade over it,
the windowed two-matmul bandpass), and the full shifted ``fft2`` spectrum,
which the parity preset, odd frame sides and every other knob combination
take, with the top-k or the cascade carrier search and the windowed or the
full-frame masked ``ifft2`` bandpass.  The post-FFT per-pixel stages run on
the compute bbox where one is given.

The dark/light assignment (whichever sign bin is darker on average) and the
global phase ``phi0`` are ``torch.where`` selects on device scalars: no host
sync.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from plainref.config import TempConfig
from plainref.ops import fftops
from plainref.ops.consts import DeviceConsts
from plainref.ops.filters import gaussian_blur
from plainref.ops.morphology import close as morph_close
from plainref.ops.morphology import dilate, ellipse_kernel, rect_kernel
from plainref.ops.morphology import open_ as morph_open
from plainref.ops.percentile import get_percentile_fn, masked_mean


class SegmentationResult(NamedTuple):
    dark: torch.Tensor          # black-TLC stripes (bool)
    light: torch.Tensor         # colored-TLC stripes (bool)
    roi_eff: torch.Tensor       # roi minus saturation
    sat: torch.Tensor           # saturated/specular pixels
    peak_xy: torch.Tensor       # (2,) int carrier peak
    angle_rad: torch.Tensor     # stripe normal direction
    period_px: torch.Tensor     # stripe period


def saturation_mask(gray: torch.Tensor, roi: torch.Tensor, cfg: TempConfig) -> torch.Tensor:
    """Specular-highlight mask: gray >= thresh inside the ROI, dilated by an
    ellipse of ``sat_dilate_ksize | 1`` and cut to the ROI again."""
    sat = (gray >= float(cfg.sat_thresh_gray)) & roi
    k = cfg.sat_dilate_ksize | 1
    if k > 1:
        sat = dilate(sat, ellipse_kernel(k, k)) & roi
    return sat


def segment_stripes(image_gray: torch.Tensor, roi: torch.Tensor, cfg: TempConfig,
                    consts: DeviceConsts, compute_bbox=None) -> SegmentationResult:
    """Dark/light stripe masks, the carrier peak and the stripe angle and
    period.  ``compute_bbox`` (static ``(y0, y1, x0, x1)``) restricts the
    post-FFT per-pixel stages to that window, which holds the ROI with
    margin, and re-embeds; the forward FFT and the carrier search stay
    full-frame."""
    h, w = image_gray.shape
    gray = image_gray.to(torch.float32)

    sat = saturation_mask(gray, roi, cfg)
    roi_eff = roi & ~sat

    med = get_percentile_fn(cfg.percentile_method)(gray, roi_eff, 50.0)
    g = torch.where(roi, gray, med)

    if cfg.seg_illum_sigma and cfg.seg_illum_sigma > 0:
        blur = gaussian_blur(g, float(cfg.seg_illum_sigma), consts, vpu=cfg.conv_vpu)
        blur = torch.where(blur < 1e-6, 1.0, blur)
        norm = g / blur
    else:
        norm = g
    mu = masked_mean(norm, roi_eff)
    mu = torch.where(torch.abs(mu) > 1e-9, mu, 1.0)
    i_norm = norm / mu

    # the JAX package's condition for the real-input half spectrum
    use_rfft = (cfg.seg_fft == "rfft2" and cfg.seg_peak_method == "cascade"
                and cfg.seg_force_right_half_plane and cfg.seg_bandpass == "matmul"
                and h % 2 == 0 and w % 2 == 0)
    peak = dict(prefer_near_center_row=cfg.seg_prefer_peak_near_center_row,
                peak_max_dy_frac=cfg.seg_peak_max_dy_from_center)
    if use_rfft:
        Rr = torch.roll(torch.fft.rfft2(i_norm), h // 2, dims=0)
        k_i, py = fftops.carrier_peak_cascade_half(torch.abs(Rr), cfg.seg_dc_exclusion,
                                                   **peak)
        px = k_i + w // 2
    else:
        F_shift = torch.fft.fftshift(torch.fft.fft2(i_norm))
        if cfg.seg_peak_method == "cascade":
            px, py = fftops.carrier_peak_cascade(
                torch.abs(F_shift), cfg.seg_dc_exclusion,
                force_right_half_plane=cfg.seg_force_right_half_plane, **peak)
        else:
            xs, ys, mags = fftops.find_top_peaks(torch.abs(F_shift), cfg.seg_dc_exclusion,
                                                 cfg.seg_n_peaks)
            px, py = fftops.choose_carrier_peak(
                xs, ys, mags, h, w, force_right_half_plane=cfg.seg_force_right_half_plane,
                **peak)

    cb = compute_bbox
    rows = slice(cb[0], cb[1]) if cb is not None else None
    cols = slice(cb[2], cb[3]) if cb is not None else None

    def crop(a):
        return a[rows, cols] if cb is not None else a

    def embed(mask_c):
        if cb is None:
            return mask_c
        full = torch.zeros((h, w), dtype=mask_c.dtype, device=mask_c.device)
        full[rows, cols] = mask_c
        return full

    radius = float(cfg.seg_band_radius)
    if use_rfft:
        z = fftops.ifft2_bandpass_dynamic_half(Rr, k_i, py, radius, consts,
                                               rows=rows, cols=cols)
    elif cfg.seg_bandpass == "matmul":
        z = fftops.ifft2_bandpass_dynamic(F_shift, px, py, radius, consts,
                                          rows=rows, cols=cols)
    else:
        # the full-frame masked inverse transform: the disk by float32
        # distances to the peak bin
        dy = consts.iota(h, w, 0) - py.to(torch.float32)
        dx = consts.iota(h, w, 1) - px.to(torch.float32)
        disk = dx * dx + dy * dy <= radius ** 2
        z = crop(torch.fft.ifft2(torch.fft.ifftshift(torch.where(disk, F_shift, 0.0))))
    roi_c = crop(roi)
    roi_eff_c = crop(roi_eff)
    gray_c = crop(gray)

    # rotate so the real part aligns with the stripe modulation
    m = crop(i_norm) - 1.0
    c = torch.where(roi_eff_c, z * m, 0.0).sum()
    phi0 = torch.where(torch.isfinite(torch.abs(c)), torch.angle(c), 0.0)
    s = torch.real(z * torch.polar(torch.ones_like(phi0), -phi0)).to(torch.float32)

    mask_a = (s >= 0) & roi_eff_c
    mask_b = (s < 0) & roi_eff_c
    mean_a = masked_mean(gray_c, mask_a, fallback=1e9)
    mean_b = masked_mean(gray_c, mask_b, fallback=1e9)
    dark = torch.where(mean_a <= mean_b, mask_a, mask_b)

    # directional cleanup; cv2 Size(kx, ky) = (width, height)
    k_close = rect_kernel(cfg.post_close_ky | 1, cfg.post_close_kx | 1)
    k_open = rect_kernel(cfg.post_open_ky | 1, cfg.post_open_kx | 1)
    dark = morph_open(morph_close(dark, k_close), k_open) & roi_c
    dark_final = embed(dark & roi_eff_c)
    light_final = roi_eff & ~dark_final

    cy, cx = h // 2, w // 2
    dx = px.to(torch.float32) - cx
    dy = py.to(torch.float32) - cy
    fmag = torch.hypot(dx / w, dy / h)
    period = torch.where(fmag > 1e-9, 1.0 / fmag, torch.nan)
    angle = torch.atan2(dy, dx)
    return SegmentationResult(dark_final, light_final, roi_eff, sat,
                              torch.stack([px, py]), angle, period)
