"""FTP complex demodulation (JAX ``ftp/demod.py``).

``ftp_complex_demod_pair`` demodulates a reference/deformed pair with the
carrier locked to the reference peak, every frame-independent stage batched
over the pair; ``ftp_complex_demod`` demodulates one frame on its own
spectrum (the unlocked per-frame demod) or at a given carrier.  Both run the
preprocessing (``preprocess``: bad-pixel repair by percentile thresholds
and K3, illumination normalization, the DC removal by the masked mean or
median unless ``remove_mean_after_apod`` is off, the optional Hann window),
symmetric FFT padding, the carrier search and one of the JAX package's
sideband tails, chosen as it chooses them:

- the half-spectrum path (``_demod_pair_rfft``: ``rfft2``, the carrier
  cascade on the reference half spectrum, the Hermitian-extended sideband
  patch) for the pair under the patch shift and the cascade search on even
  FFT sizes, as the deploy presets run it;
- the full-``fft2`` path (``fftshift``ed spectrum, the 'topk' or cascade
  carrier search) otherwise, as the parity preset runs it, with the patch
  shift (the Hann-windowed patch inverted by a sparse inverse DFT and the
  fractional-bin ramp) or the Gaussian sideband (a dense ``ifft2`` of the
  spectrum under a truncated Gaussian with a DC notch, and the full-carrier
  ramp).

The carrier is refined by a parabola in the log magnitude.  Every function
takes (..., h, w) stacks of frames (``jax.vmap`` of the JAX demod): one
carrier a pair, the peaks and windows per pair on the device.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import torch

from plainref.config import FTPConfig
from plainref.ops import fftops
from plainref.ops.consts import DeviceConsts
from plainref.ops.filters import gaussian_blur, gradient_magnitude, hann_patch
from plainref.ops.inpaint import inpaint_diffusion
from plainref.ops.morphology import dilate, ellipse_kernel
from plainref.ops.padding import pad_last2
from plainref.ops.percentile import (get_percentile_fn, masked_mean,
                                        masked_percentile_hist_rows)
from plainref.ops.streams import each
from plainref.ops.warp import window_rows_cols


class DemodResult(NamedTuple):
    complex_demod: torch.Tensor      # (..., h, w) complex64, carrier removed
    amp: torch.Tensor                # (..., h, w) float32 |complex_demod|
    peak_f: torch.Tensor             # (..., 2) refined peak (x, y) in bins
    k: torch.Tensor                  # (..., 2) carrier offset from DC (kx, ky)
    fft_shape: Tuple[int, int]       # (hf, wf)
    i_norm: torch.Tensor             # (..., h, w) normalized image


def preprocess(gray: torch.Tensor, apo: Optional[torch.Tensor], cfg: FTPConfig,
               consts: DeviceConsts, streams: bool = False
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bad-pixel repair, illumination normalization, apodization, the DC
    removal and the Hann window of the (..., h, w) gray planes: returns
    (windowed image, I_norm).  ``streams``: the leading axis is a batched
    forward's stream axis (``ops/streams.py``), here and below."""
    img = gray.to(torch.float32)
    h, w = img.shape[-2:]
    valid = apo > 1e-6 if apo is not None else torch.ones((h, w), dtype=torch.bool,
                                                          device=img.device)
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

    blur = gaussian_blur(img, cfg.illum_sigma_px, consts, streams=streams)
    i_norm = img / (blur + 1e-6) - 1.0
    if cfg.pre_blur_sigma_px and cfg.pre_blur_sigma_px > 0:
        i_norm = gaussian_blur(i_norm, cfg.pre_blur_sigma_px, consts, streams=streams)
    iw = i_norm * apo if apo is not None else i_norm
    if cfg.remove_mean_after_apod:
        if cfg.dc_remove_stat == "mean":
            mu = masked_mean(iw, valid, streams=streams)
        else:
            mu = get_percentile_fn(cfg.percentile_method)(iw, valid, 50.0)
        iw = iw - mu[..., None, None]
    if cfg.use_hann_window:
        # the plain product of two np.hanning, not cv2's square root
        iw = iw * consts.get(("hann_patch", h, w), lambda: hann_patch(h, w))
    return iw, i_norm


def _results(field: torch.Tensor, peak_f: torch.Tensor, i_norm: torch.Tensor,
             fft_shape: Tuple[int, int], cfg: FTPConfig) -> List[DemodResult]:
    """One DemodResult a frame of the (..., n, hf, wf) padded field, cropped
    to the (..., n, h, w) frames of ``i_norm``."""
    hf, wf = fft_shape
    h, w = i_norm.shape[-2:]
    pad = int(max(0, cfg.fft_pad_px))
    if pad > 0:
        field = field[..., pad:pad + h, pad:pad + w]
    amp = torch.abs(field)
    k = torch.stack([peak_f[..., 0] - wf // 2, peak_f[..., 1] - hf // 2], dim=-1)
    return [DemodResult(field[..., i, :, :], amp[..., i, :, :], peak_f, k, (hf, wf),
                        i_norm[..., i, :, :])
            for i in range(field.shape[-3])]


def _patch_field(peak_f: torch.Tensor, px_i, py_i, patch: torch.Tensor,
                 fft_shape: Tuple[int, int], cfg: FTPConfig,
                 consts: DeviceConsts, streams: bool = False) -> torch.Tensor:
    """Hann window on the (..., n, psz, psz) sideband patch, its sparse
    inverse DFT from the spectrum's centre and the fractional-bin ramp: the
    (..., n, hf, wf) padded field."""
    hf, wf = fft_shape
    psz = patch.shape[-1]
    if cfg.patch_window == "hann":
        patch = patch * consts.get(("hann_patch", psz, psz), lambda: hann_patch(psz, psz))
    field = fftops.ifft2_sparse_patch(patch, hf, wf, hf // 2 - psz // 2, wf // 2 - psz // 2,
                                      consts, streams=streams)
    dpx = peak_f[..., 0] - px_i.to(torch.float32)
    dpy = peak_f[..., 1] - py_i.to(torch.float32)
    return field * fftops.frac_ramp(hf, wf, dpx, dpy, consts, sign=-1.0)[..., None, :, :]


def _gauss_field(F_shift: torch.Tensor, peak_f: torch.Tensor, cfg: FTPConfig,
                 consts: DeviceConsts, streams: bool = False) -> torch.Tensor:
    """The Gaussian sideband of the (..., n, hf, wf) shifted spectrum: a
    Gaussian of ``band_radius`` around the carrier, truncated at
    ``gauss_trunc_radius``, zero within ``dc_exclusion`` of DC, a dense
    ``ifft2`` and the full-carrier ramp: the (..., n, hf, wf) padded
    field."""
    hf, wf = F_shift.shape[-2:]
    cy, cx = hf // 2, wf // 2
    yy = consts.iota(hf, wf, 0)
    xx = consts.iota(hf, wf, 1)
    px, py = peak_f[..., 0, None, None, None], peak_f[..., 1, None, None, None]
    dist2_peak = (xx - px) ** 2 + (yy - py) ** 2
    dist2_dc = (xx - cx) ** 2 + (yy - cy) ** 2
    sigma = max(1e-6, float(cfg.band_radius))
    gauss = torch.exp(-0.5 * dist2_peak / (sigma * sigma))
    rcut = max(3.0, float(cfg.gauss_trunc_radius))
    gauss = gauss * (dist2_peak <= rcut * rcut)
    gauss = torch.where(dist2_dc <= float(cfg.dc_exclusion) ** 2, 0.0, gauss)
    field = each(torch.fft.ifft2, torch.fft.ifftshift(F_shift * gauss, dim=(-2, -1)),
                 streams=streams, cpu_only=True)
    return field * fftops.frac_ramp(hf, wf, peak_f[..., 0] - cx, peak_f[..., 1] - cy, consts,
                                    sign=-1.0)[..., None, :, :]


def _search_carrier(mag: torch.Tensor, cfg: FTPConfig) -> torch.Tensor:
    """The refined carrier peak (..., 2) = (x, y) of the (..., hf, wf)
    shifted magnitude: the 'topk' search (or the cascade) and the parabolic
    log refinement."""
    hf, wf = mag.shape[-2:]
    if cfg.peak_method == "cascade":
        px, py = fftops.carrier_peak_cascade(
            mag, cfg.dc_exclusion, force_right_half_plane=cfg.force_right_half_plane,
            prefer_near_center_row=cfg.prefer_peak_near_center_row,
            peak_max_dy_frac=cfg.peak_max_dy_from_center)
    else:
        xs, ys, mags = fftops.find_top_peaks(mag, cfg.dc_exclusion, cfg.n_fft_peaks)
        px, py = fftops.choose_carrier_peak(
            xs, ys, mags, hf, wf, force_right_half_plane=cfg.force_right_half_plane,
            prefer_near_center_row=cfg.prefer_peak_near_center_row,
            peak_max_dy_frac=cfg.peak_max_dy_from_center)
    fx, fy = fftops.refine_peak_parabolic_log(mag, px, py)
    return torch.stack([fx, fy], dim=-1)


def _fft2_field(F_shift: torch.Tensor, peak_f: torch.Tensor, cfg: FTPConfig,
                consts: DeviceConsts, streams: bool = False) -> torch.Tensor:
    """The full-``fft2`` tail of the (..., n, hf, wf) shifted spectrum at
    the carrier ``peak_f``: the sideband patch around its rounded bin (the
    window start clamped into the array, as ``dynamic_slice`` clamps it),
    or the Gaussian sideband."""
    if cfg.sideband_method != "patch_shift":
        return _gauss_field(F_shift, peak_f, cfg, consts, streams=streams)
    hf, wf = F_shift.shape[-2:]
    px_i = torch.round(peak_f[..., 0]).to(torch.int64)
    py_i = torch.round(peak_f[..., 1]).to(torch.int64)
    bw = int(max(3, cfg.patch_half_width_bins))
    psz = 2 * bw + 1
    win = torch.arange(psz, device=F_shift.device)
    rows = torch.clamp(py_i - bw, 0, hf - psz)[..., None] + win
    cols = torch.clamp(px_i - bw, 0, wf - psz)[..., None] + win
    patch = window_rows_cols(F_shift, rows, cols)
    return _patch_field(peak_f, px_i, py_i, patch, (hf, wf), cfg, consts, streams=streams)


def _demod_pair_rfft(iw_fft: torch.Tensor, cfg: FTPConfig, streams: bool = False):
    """Half-spectrum carrier search in the row-shifted rfft layout
    ``Rr[r, k] == F_shift[r, cx + k]``: returns (peak (x, y), rounded x,
    rounded y, the pair's (2, psz, psz) sideband patch around it), the
    patch's negative-kx columns from Hermitian symmetry; for a (..., 2, hf,
    wf) stack of pairs, each pair's own."""
    hf, wf = iw_fft.shape[-2:]
    cy, cx = hf // 2, wf // 2
    bw = int(max(3, cfg.patch_half_width_bins))
    psz = 2 * bw + 1

    Rr = torch.roll(each(torch.fft.rfft2, iw_fft, streams=streams, cpu_only=True), cy, dims=-2)
    mag_half = torch.abs(Rr[..., 0, :, :])              # (..., hf, cx + 1)
    kw = mag_half.shape[-1]

    # carrier cascade over the half plane (the TPU graph's inline form)
    dc = int(cfg.dc_exclusion)
    iy = torch.arange(hf, device=Rr.device)[:, None]
    ik = torch.arange(kw, device=Rr.device)[None, :]
    notch = (ik < dc) & (iy >= cy - dc) & (iy < cy + dc)
    m1 = (~notch) & (ik >= 1)
    m2 = (m1 & (torch.abs(iy - cy) <= int(cfg.peak_max_dy_from_center * hf))
          if cfg.prefer_peak_near_center_row else m1)
    i2 = torch.argmax(torch.where(m2, mag_half, -3.0e38).flatten(-2), dim=-1)
    i1 = torch.argmax(torch.where(m1, mag_half, -3.0e38).flatten(-2), dim=-1)
    idx = torch.where(m2.any(), i2, i1)
    fx_h, fy = fftops.refine_peak_parabolic_log(mag_half, idx % kw, idx // kw)
    peak_f = torch.stack([fx_h + float(cx), fy], dim=-1)
    px_i = torch.round(peak_f[..., 0]).to(torch.int64)
    py_i = torch.round(peak_f[..., 1]).to(torch.int64)

    # Hermitian extension: bw negative-kx columns (mirror[r, k] = F_shift[r, cx - k])
    mirror = torch.conj(torch.roll(torch.flip(Rr, dims=(-2,)), 1, dims=-2))
    E = torch.cat([torch.flip(mirror[..., 1:bw + 1], dims=(-1,)), Rr], dim=-1)
    # dynamic_slice semantics: the window start is clamped into the array
    sy = torch.clamp(py_i - bw, 0, hf - psz)[..., None]
    sx = torch.clamp(px_i - cx, 0, E.shape[-1] - psz)[..., None]
    win = torch.arange(psz, device=Rr.device)
    patch = window_rows_cols(E, sy + win, sx + win)
    return peak_f, px_i, py_i, patch


def _pad_fft(iw: torch.Tensor, cfg: FTPConfig) -> torch.Tensor:
    """The windowed planes padded by ``fft_pad_px`` with the symmetric
    (cv2 BORDER_REFLECT) border."""
    pad = int(max(0, cfg.fft_pad_px))
    return pad_last2(iw, (pad, pad, pad, pad), "symmetric") if pad > 0 else iw


def ftp_complex_demod_pair(gray_ref: torch.Tensor, gray_def: torch.Tensor,
                           apo: Optional[torch.Tensor], cfg: FTPConfig,
                           consts: DeviceConsts, streams: bool = False
                           ) -> Tuple[DemodResult, DemodResult]:
    """Demodulate a reference/deformed pair with the carrier locked to the
    reference peak, every frame-independent stage batched over the pair
    (and over the streams of (..., h, w) stacks; ``streams`` as in
    ``preprocess``)."""
    iw_pair, i_norm_pair = preprocess(torch.stack([gray_ref, gray_def], dim=-3), apo, cfg,
                                      consts, streams=streams)
    iw_fft = _pad_fft(iw_pair, cfg)
    hf, wf = iw_fft.shape[-2:]
    if (cfg.sideband_method == "patch_shift" and cfg.force_right_half_plane
            and cfg.peak_method == "cascade" and hf % 2 == 0 and wf % 2 == 0
            and min(hf, wf) >= cfg.demod_rfft_min_px):
        peak_f, px_i, py_i, patch = _demod_pair_rfft(iw_fft, cfg, streams=streams)
        field = _patch_field(peak_f, px_i, py_i, patch, (hf, wf), cfg, consts, streams=streams)
    else:
        F_shift = torch.fft.fftshift(each(torch.fft.fft2, iw_fft, streams=streams,
                                          cpu_only=True), dim=(-2, -1))
        peak_f = _search_carrier(torch.abs(F_shift[..., 0, :, :]), cfg)
        field = _fft2_field(F_shift, peak_f, cfg, consts, streams=streams)
    dref, ddef = _results(field, peak_f, i_norm_pair, (hf, wf), cfg)
    return dref, ddef


def ftp_complex_demod(gray: torch.Tensor, apo: Optional[torch.Tensor], cfg: FTPConfig,
                      consts: DeviceConsts,
                      carrier_refined: Optional[torch.Tensor] = None,
                      streams: bool = False) -> DemodResult:
    """Demodulate one frame on its own full spectrum: the carrier searched
    and refined there, or locked to ``carrier_refined`` (x, y) in bins;
    ``streams`` as in ``preprocess``."""
    iw, i_norm = preprocess(gray[..., None, :, :], apo, cfg, consts, streams=streams)
    F_shift = torch.fft.fftshift(each(torch.fft.fft2, _pad_fft(iw, cfg), streams=streams,
                                      cpu_only=True), dim=(-2, -1))
    peak_f = (_search_carrier(torch.abs(F_shift[..., 0, :, :]), cfg) if carrier_refined is None
              else carrier_refined.to(torch.float32))
    field = _fft2_field(F_shift, peak_f, cfg, consts, streams=streams)
    return _results(field, peak_f, i_norm, tuple(F_shift.shape[-2:]), cfg)[0]
