"""FTP complex demodulation of a frame pair (JAX ``ftp/demod.py``).

The port runs ``ftp_complex_demod_pair``: bad-pixel repair (percentile
thresholds, K3 inpaint) and illumination normalization batched over the
pair, the DC removal by the masked mean or median, symmetric FFT padding,
then one of the JAX package's two tails, chosen as it chooses them:

- the half-spectrum path (``_demod_pair_rfft``: ``rfft2``, the carrier
  cascade on the reference half spectrum, the Hermitian-extended sideband
  patch) for the cascade search on even FFT sizes, as the deploy presets
  run it;
- the full-``fft2`` path (``_demod_pair_fft2``: ``fftshift``ed spectrum,
  the 'topk' or cascade carrier search, the sideband patch) otherwise, as
  the parity preset runs it.

Both refine the carrier by a parabola in the log magnitude and invert the
Hann-windowed patch by a sparse inverse DFT.  The Gaussian sideband,
unlocked per-frame demodulation and the Hann window are not ported yet.
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
from vistaf_torch.ops.percentile import (get_percentile_fn, masked_mean,
                                        masked_percentile_hist_rows)


class DemodResult(NamedTuple):
    complex_demod: torch.Tensor      # (h, w) complex64, carrier removed
    amp: torch.Tensor                # (h, w) float32 |complex_demod|
    peak_f: torch.Tensor             # (2,) refined peak (x, y) in bins
    k: torch.Tensor                  # (2,) carrier offset from DC (kx, ky)
    fft_shape: Tuple[int, int]       # (hf, wf)
    i_norm: torch.Tensor             # (h, w) normalized image


def check_config(cfg: FTPConfig) -> None:
    """Raise NotImplementedError, naming the knobs, for a configuration whose
    demodulation is not ported: the Gaussian sideband
    (``sideband_method='gauss'``), the unlocked per-frame demodulation
    (``lock_carrier_to_reference=False``), the Hann window and a
    preprocessing without the DC removal."""
    unported = {
        "sideband_method (Gaussian sideband)": cfg.sideband_method != "patch_shift",
        "lock_carrier_to_reference (unlocked demod)": not cfg.lock_carrier_to_reference,
        "use_hann_window": cfg.use_hann_window,
        "remove_mean_after_apod": not cfg.remove_mean_after_apod,
        "peak_method": cfg.peak_method not in ("topk", "cascade"),
    }
    bad = [k for k, v in unported.items() if v]
    if bad:
        raise NotImplementedError(f"vistaf_torch does not port {bad} yet")


def preprocess(gray: torch.Tensor, apo: Optional[torch.Tensor], cfg: FTPConfig,
               consts: DeviceConsts) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bad-pixel repair, illumination normalization and apodization of the
    (..., h, w) gray planes: returns (windowed image, I_norm)."""
    img = gray.to(torch.float32)
    valid = apo > 1e-6 if apo is not None else torch.ones_like(img[0], dtype=torch.bool)
    if cfg.bad_pixel_enable:
        grad = gradient_magnitude(img)
        qs = (cfg.bad_intensity_percentile, cfg.bad_gradient_percentile)
        if cfg.percentile_method == "hist":
            # the JAX route: one 64-bin rows call over each frame's image
            # and gradient
            rows = torch.stack([img, grad], dim=-3).flatten(-2)
            thr = masked_percentile_hist_rows(rows, valid.reshape(-1), qs, bins=64)
            hi_thr, g_thr = thr[..., 0, None, None], thr[..., 1, None, None]
        else:
            pctl = get_percentile_fn(cfg.percentile_method)
            hi_thr = pctl(img, valid, qs[0])[..., None, None]
            g_thr = pctl(grad, valid, qs[1])[..., None, None]
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
    if cfg.dc_remove_stat == "mean":
        mu = masked_mean(iw, valid)
    else:
        mu = get_percentile_fn(cfg.percentile_method)(iw, valid, 50.0)
    return iw - mu[..., None, None], i_norm


def _patch_tail(peak_f: torch.Tensor, px_i, py_i, patch: torch.Tensor,
                i_norm_pair: torch.Tensor, fft_shape: Tuple[int, int], cfg: FTPConfig,
                consts: DeviceConsts) -> Tuple[DemodResult, DemodResult]:
    """Hann window on the (2, psz, psz) sideband patch, its sparse inverse
    DFT from the spectrum's centre, the fractional-bin ramp and the crop."""
    hf, wf = fft_shape
    h, w = i_norm_pair.shape[-2:]
    cy, cx = hf // 2, wf // 2
    pad = int(max(0, cfg.fft_pad_px))
    psz = patch.shape[-1]
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


def _demod_pair_fft2(iw_fft: torch.Tensor, cfg: FTPConfig):
    """Full-spectrum carrier search on the reference: ``fft2`` of the pair,
    ``fftshift``, the 'topk' search (or the cascade) and parabolic
    refinement; returns (peak (x, y), rounded x, rounded y, the pair's
    (2, psz, psz) sideband patch around it)."""
    _, hf, wf = iw_fft.shape
    F_shift = torch.fft.fftshift(torch.fft.fft2(iw_fft), dim=(-2, -1))
    ref_mag = torch.abs(F_shift[0])
    if cfg.peak_method == "cascade":
        px, py = fftops.carrier_peak_cascade(
            ref_mag, cfg.dc_exclusion, force_right_half_plane=cfg.force_right_half_plane,
            prefer_near_center_row=cfg.prefer_peak_near_center_row,
            peak_max_dy_frac=cfg.peak_max_dy_from_center)
    else:
        xs, ys, mags = fftops.find_top_peaks(ref_mag, cfg.dc_exclusion, cfg.n_fft_peaks)
        px, py = fftops.choose_carrier_peak(
            xs, ys, mags, hf, wf, force_right_half_plane=cfg.force_right_half_plane,
            prefer_near_center_row=cfg.prefer_peak_near_center_row,
            peak_max_dy_frac=cfg.peak_max_dy_from_center)
    fx, fy = fftops.refine_peak_parabolic_log(ref_mag, px, py)
    peak_f = torch.stack([fx, fy])
    px_i = torch.round(peak_f[0]).to(torch.int64)
    py_i = torch.round(peak_f[1]).to(torch.int64)
    bw = int(max(3, cfg.patch_half_width_bins))
    psz = 2 * bw + 1
    # dynamic_slice semantics: the window start is clamped into the array
    win = torch.arange(psz, device=iw_fft.device)
    rows = torch.clamp(py_i - bw, 0, hf - psz) + win
    cols = torch.clamp(px_i - bw, 0, wf - psz) + win
    patch = F_shift.index_select(-2, rows).index_select(-1, cols)
    return peak_f, px_i, py_i, patch


def _demod_pair_rfft(iw_fft: torch.Tensor, cfg: FTPConfig):
    """Half-spectrum carrier search in the row-shifted rfft layout
    ``Rr[r, k] == F_shift[r, cx + k]``; returns what ``_demod_pair_fft2``
    returns, the patch's negative-kx columns from Hermitian symmetry."""
    _, hf, wf = iw_fft.shape
    cy, cx = hf // 2, wf // 2
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
    return peak_f, px_i, py_i, patch


def ftp_complex_demod_pair(gray_ref: torch.Tensor, gray_def: torch.Tensor,
                           apo: Optional[torch.Tensor], cfg: FTPConfig,
                           consts: DeviceConsts) -> Tuple[DemodResult, DemodResult]:
    """Demodulate a reference/deformed pair with the carrier locked to the
    reference peak, every frame-independent stage batched over the pair."""
    check_config(cfg)
    iw_pair, i_norm_pair = preprocess(torch.stack([gray_ref, gray_def]), apo, cfg, consts)
    pad = int(max(0, cfg.fft_pad_px))
    iw_fft = pad_last2(iw_pair, (pad, pad, pad, pad), "symmetric") if pad > 0 else iw_pair
    hf, wf = iw_fft.shape[-2:]
    if (cfg.force_right_half_plane and cfg.peak_method == "cascade" and hf % 2 == 0
            and wf % 2 == 0 and min(hf, wf) >= cfg.demod_rfft_min_px):
        peak = _demod_pair_rfft(iw_fft, cfg)
    else:
        peak = _demod_pair_fft2(iw_fft, cfg)
    return _patch_tail(*peak, i_norm_pair, (hf, wf), cfg, consts)
