"""Reference debug-artifact dump contract (JAX ``runner/debug_artifacts.py``).

Reproduces the filename set the reference writes with ``DEBUG=True`` /
``SAVE_SUMMARY_FIGURES=True`` so downstream tooling pointed at a session
directory keeps working:

FTP (``shape_ftp.py:915-922, 999-1024, 1357-1422, 1625, 1691-1699,
1988-2007``):
  debug_log.txt
  DEBUG_fft_peaks_{ref,def}.png
  DEBUG_complex_amplitude_{ref,def}.png
  DEBUG_phase_wrapped_{ref,def}.png
  DEBUG_phase_unwrapped_{ref,def}.png
  DEBUG_ramp_phase_diff.png, DEBUG_ramp_cross_phase_diff.png
  DEBUG_phase_diff_wrapped.png
  03_ref_def_crops_with_roi.png
  05_fft_debug_panels.png
  07_phase_and_height_FINAL_SMOOTH_ROI.png
  (+ DEBUG_grating_prealign_inputs.png when the prealign pass is enabled)

Temperature (``temperature_sensor.py:814-827``):
  debug_seg_overlay.png, debug_fft_mag.png, debug_chroma_u8.png

Figures carry the same information (content layout is matplotlib-default,
not pixel-identical to the reference's panels).  The FTP set reads the
``dbg_*`` keys of the port's ``FTPPipeline(debug_outputs=True)`` result, which
carries the JAX package's names.
"""
from __future__ import annotations

import os
from typing import Any, Dict, Optional

import numpy as np


def _plt():
    import matplotlib
    matplotlib.use("Agg", force=True)
    import matplotlib.pyplot as plt
    return plt


def _save(fig, outdir: str, name: str) -> None:
    fig.savefig(os.path.join(outdir, name), dpi=150, bbox_inches="tight")
    _plt().close(fig)


def _fft_mag(i_norm: np.ndarray, apo: Optional[np.ndarray], pad: int) -> np.ndarray:
    x = np.asarray(i_norm, np.float32)
    if apo is not None:
        x = x * np.asarray(apo, np.float32)
    x = x - np.nanmean(x)
    if pad > 0:
        x = np.pad(x, pad, mode="symmetric")
    return np.abs(np.fft.fftshift(np.fft.fft2(np.nan_to_num(x))))


def _unwrap_np(phase: np.ndarray) -> np.ndarray:
    """Cheap two-pass row/column unwrap for the per-frame debug panels (the
    reference uses skimage.unwrap_phase here, for display only)."""
    p = np.unwrap(np.asarray(phase, np.float64), axis=1)
    return np.unwrap(p, axis=0).astype(np.float32)


def write_ftp_debug(outdir: str, res: Dict[str, Any], cfg, apo=None,
                    log_lines=None) -> None:
    """Write the FTP DEBUG_* figure set + debug_log.txt from a
    ``FTPPipeline(debug_outputs=True)`` result dict."""
    plt = _plt()
    os.makedirs(outdir, exist_ok=True)

    with open(os.path.join(outdir, "debug_log.txt"), "w", encoding="utf-8") as fh:
        fh.write("[FTP] vistaf-tpu debug run\n")
        fh.write(f"[FFT] carrier k ref = {np.asarray(res.get('carrier_k_ref'))}\n")
        fh.write(f"[FFT] carrier k def = {np.asarray(res.get('carrier_k_def'))}\n")
        fh.write(f"[FFT] estimated grating period = "
                 f"{res.get('estimated_grating_period_px')}\n")
        for line in (log_lines or []):
            fh.write(str(line) + "\n")

    pad = int(getattr(cfg, "fft_pad_px", 0))
    for tag in ("ref", "def"):
        i_norm = res.get(f"dbg_i_norm_{tag}")
        amp = res.get(f"dbg_amp_{tag}")
        phase = res.get(f"dbg_phase_{tag}")

        if i_norm is not None:
            mag = _fft_mag(i_norm, apo, pad)
            fig, ax = plt.subplots(figsize=(6, 5))
            ax.imshow(np.log1p(mag), cmap="gray")
            ax.set_title(f"{tag}: FFT magnitude (log), carrier marked")
            k = np.asarray(res.get(f"carrier_k_{tag}", (0, 0)))
            ax.plot([mag.shape[1] // 2 + k[0]], [mag.shape[0] // 2 + k[1]], "r+")
            ax.axis("off")
            _save(fig, outdir, f"DEBUG_fft_peaks_{tag}.png")

        if amp is not None:
            fig, ax = plt.subplots(figsize=(6, 5))
            im = ax.imshow(amp, cmap="viridis")
            ax.set_title(f"{tag}: |complex demod| (amplitude)")
            fig.colorbar(im, ax=ax, shrink=0.75)
            ax.axis("off")
            _save(fig, outdir, f"DEBUG_complex_amplitude_{tag}.png")

        if phase is not None:
            fig, ax = plt.subplots(figsize=(6, 5))
            im = ax.imshow(phase, cmap="twilight")
            ax.set_title(f"{tag}: wrapped phase")
            fig.colorbar(im, ax=ax, shrink=0.75)
            ax.axis("off")
            _save(fig, outdir, f"DEBUG_phase_wrapped_{tag}.png")

            fig, ax = plt.subplots(figsize=(6, 5))
            im = ax.imshow(_unwrap_np(phase), cmap="viridis")
            ax.set_title(f"{tag}: unwrapped phase (display)")
            fig.colorbar(im, ax=ax, shrink=0.75)
            ax.axis("off")
            _save(fig, outdir, f"DEBUG_phase_unwrapped_{tag}.png")

    wrapped = res.get("phase_wrapped_crop")
    if wrapped is not None:
        fig, ax = plt.subplots(figsize=(6, 5))
        im = ax.imshow(wrapped, cmap="twilight")
        ax.set_title("Wrapped phase difference (def - ref)")
        fig.colorbar(im, ax=ax, shrink=0.75)
        ax.axis("off")
        _save(fig, outdir, "DEBUG_phase_diff_wrapped.png")

    # ramp diagnostics (debug_ramp, shape_ftp.py:1357-1422): unwrapped phase
    # difference + row/column cross-sections
    unw = res.get("dbg_unwrapped")
    if unw is not None:
        fig, ax = plt.subplots(figsize=(6, 5))
        im = ax.imshow(unw, cmap="viridis")
        ax.set_title("phase_diff: unwrapped (ramp diagnostic)")
        fig.colorbar(im, ax=ax, shrink=0.75)
        ax.axis("off")
        _save(fig, outdir, "DEBUG_ramp_phase_diff.png")

        h, w = unw.shape
        fig, axes = plt.subplots(1, 2, figsize=(10, 4))
        axes[0].plot(np.asarray(unw)[h // 2, :])
        axes[0].set_title("center row")
        axes[1].plot(np.asarray(unw)[:, w // 2])
        axes[1].set_title("center column")
        _save(fig, outdir, "DEBUG_ramp_cross_phase_diff.png")

    # summary figures (SAVE_SUMMARY_FIGURES)
    rg = res.get("dbg_ref_gray")
    dg = res.get("dbg_def_gray_aligned")
    if rg is not None and dg is not None:
        fig, axes = plt.subplots(1, 2, figsize=(10, 5))
        axes[0].imshow(rg, cmap="gray")
        axes[0].set_title("Reference crop")
        axes[1].imshow(dg, cmap="gray")
        axes[1].set_title("Deformed crop (aligned)")
        for a in axes:
            a.axis("off")
        _save(fig, outdir, "03_ref_def_crops_with_roi.png")

    i_norm_def = res.get("dbg_i_norm_def")
    if i_norm_def is not None:
        mag = _fft_mag(i_norm_def, apo, pad)
        fig, axes = plt.subplots(1, 3, figsize=(12, 4))
        axes[0].imshow(np.log1p(mag), cmap="gray")
        axes[0].set_title("Deformed FFT magnitude (log)")
        axes[1].imshow(np.log1p(_fft_mag(res.get("dbg_amp_def"), None, 0)), cmap="gray")
        axes[1].set_title("Sideband content (def)")
        axes[2].imshow(np.asarray(i_norm_def), cmap="gray")
        axes[2].set_title("I_def normalized")
        for a in axes:
            a.axis("off")
        _save(fig, outdir, "05_fft_debug_panels.png")

    hm = res.get("height_map_mm_crop")
    if hm is not None and wrapped is not None:
        fig, axes = plt.subplots(1, 2, figsize=(11, 5))
        im0 = axes[0].imshow(wrapped, cmap="twilight")
        axes[0].set_title("Wrapped phase difference")
        fig.colorbar(im0, ax=axes[0], shrink=0.7)
        im1 = axes[1].imshow(hm, cmap="viridis")
        axes[1].set_title("Final smoothed height (mm)")
        fig.colorbar(im1, ax=axes[1], shrink=0.7)
        for a in axes:
            a.axis("off")
        _save(fig, outdir, "07_phase_and_height_FINAL_SMOOTH_ROI.png")


def write_temperature_debug(outdir: str, img_bgr: np.ndarray,
                            tres: Dict[str, Any], bbox=None) -> None:
    """Temperature debug PNG set (``temperature_sensor.py:814-827``)."""
    import cv2

    os.makedirs(outdir, exist_ok=True)

    def crop(a):
        # bbox is (y0, y1, x0, x1) as produced by ops.geometry.bbox_from_mask
        # (the TemperaturePipeline crop_bbox convention) — reuse io.crop2d.
        from vistaf_torch.runner.io import crop2d
        return crop2d(a, bbox)

    gray = cv2.cvtColor(img_bgr, cv2.COLOR_BGR2GRAY)
    roi = np.asarray(tres["roi_full"], bool)
    dark = np.asarray(tres["mask_dark"], bool)

    overlay = cv2.cvtColor(gray, cv2.COLOR_GRAY2BGR)
    overlay[dark & roi] = (0, 0, 255)
    edge = roi & ~cv2.erode(roi.astype(np.uint8), np.ones((3, 3), np.uint8)).astype(bool)
    overlay[edge] = (0, 255, 0)
    cv2.imwrite(os.path.join(outdir, "debug_seg_overlay.png"), crop(overlay))

    fft_mag = np.asarray(tres.get("seg_fft_mag")) if "seg_fft_mag" in tres else None
    if fft_mag is None:
        fft_mag = np.abs(np.fft.fftshift(np.fft.fft2(gray.astype(np.float32))))
    m = np.log1p(fft_mag)
    m_u8 = np.clip(m / (m.max() + 1e-9) * 255.0, 0, 255).astype(np.uint8)
    cv2.imwrite(os.path.join(outdir, "debug_fft_mag.png"), m_u8)

    if "chroma" in tres:
        chroma = np.asarray(tres["chroma"], np.float32).copy()
    else:  # fused-kernel path keeps chroma in VMEM; recompute host-side
        lab = cv2.cvtColor(img_bgr, cv2.COLOR_BGR2LAB)
        chroma = np.hypot(lab[..., 1].astype(np.float32) - 128.0,
                          lab[..., 2].astype(np.float32) - 128.0)
    chroma[~roi] = 0
    denom = (np.nanpercentile(chroma[roi], 99) + 1e-6) if roi.any() else 1.0
    ch_u8 = np.clip(chroma / denom * 255.0, 0, 255).astype(np.uint8)
    cv2.imwrite(os.path.join(outdir, "debug_chroma_u8.png"), crop(ch_u8))


def write_temperature_raw_maps(outdir: str, img_bgr: np.ndarray,
                               tres: Dict[str, Any], cfg, bbox=None) -> None:
    """The reference's UNCONDITIONAL raw-prediction artifact set
    (``temperature_sensor.py:873-927``): wide/color raw colormaps (incl.
    dark-only / light-only wide variants), the fused-source PNG and the
    fused colormap + overlay.  The dark/light variants reuse the exported
    raw wide prediction — model values are mask-independent, so masking
    post-hoc equals the reference's predict-on-mask."""
    import cv2

    from vistaf_torch.runner import figures
    from vistaf_torch.runner.io import crop2d

    os.makedirs(outdir, exist_ok=True)
    stats_roi = np.asarray(tres["roi_outer"] if cfg.crop_output_to_outer_roi
                           else tres["roi_full"], bool)
    roi_c = crop2d(stats_roi, bbox)
    wide_raw = np.asarray(tres["wide_map_raw"], np.float32)
    color_raw = np.asarray(tres["color_map_raw"], np.float32)
    dark = np.asarray(tres["mask_dark"], bool)
    light = np.asarray(tres["mask_light"], bool)

    def cmap(arr, name, vmin, vmax):
        figures.save_temperature_colormap(outdir, crop2d(arr, bbox), roi_c,
                                          name, vmin, vmax)

    cmap(np.where(dark, wide_raw, np.nan),
         "debug_wide_raw_dark_only_colormap.png", cfg.final_t_min, cfg.final_t_max)
    cmap(np.where(light, wide_raw, np.nan),
         "debug_wide_raw_light_only_colormap.png", cfg.final_t_min, cfg.final_t_max)
    cmap(wide_raw, "debug_wide_raw_colormap.png", cfg.final_t_min, cfg.final_t_max)
    cmap(color_raw, "debug_color_raw_colormap_20_33.png",
         cfg.color_t_min, cfg.color_t_max)
    cmap(color_raw, "debug_color_raw_colormap_20_75.png",
         cfg.final_t_min, cfg.final_t_max)

    cv2.imwrite(os.path.join(outdir, "debug_fused_source.png"),
                crop2d(np.asarray(tres["source_map"], np.uint8), bbox))

    fused = np.asarray(tres["temperature_map_fused"], np.float32)
    figures.save_temperature_colormap(outdir, crop2d(fused, bbox), roi_c,
                                      "temperature_map_fused_colormap.png",
                                      cfg.final_t_min, cfg.final_t_max)
    figures.save_temperature_overlay(outdir, crop2d(img_bgr, bbox),
                                     crop2d(fused, bbox), roi_c,
                                     "temperature_map_fused_colormap_overlay.png",
                                     cfg.final_t_min, cfg.final_t_max)
