"""Synthetic grating scenes and resolution-scaled configs (numpy only).

Same code as the JAX package's ``utils/synthetic.py``: the frames are byte-identical
for the same arguments, so the port and the reference run the same scene.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from vistaf_torch.config import FTPConfig
from vistaf_torch.ops.geometry import circle_from_3_points


def scaled_ftp_config(height: int, width: int,
                      base: Optional[FTPConfig] = None) -> FTPConfig:
    """FTPConfig with every pixel-dimension parameter scaled from the native
    3840x2160 geometry to (height, width)."""
    base = base or FTPConfig()
    sx = width / base.image_width
    sy = height / base.image_height
    s = float(np.sqrt(sx * sy))

    def pt(p):
        return (int(round(p[0] * sx)), int(round(p[1] * sy)))

    def px(v, lo=1):
        return max(lo, int(round(v * s)))

    return base.replace(
        image_height=height,
        image_width=width,
        outer_circle_p1=pt(base.outer_circle_p1),
        outer_circle_p2=pt(base.outer_circle_p2),
        outer_circle_p3=pt(base.outer_circle_p3),
        fft_pad_px=px(base.fft_pad_px, 0),
        pre_blur_sigma_px=max(0.4, base.pre_blur_sigma_px * s),
        illum_sigma_px=max(2.0, base.illum_sigma_px * s),
        apod_taper_px=px(base.apod_taper_px),
        quality_smooth_sigma_px=max(1.0, base.quality_smooth_sigma_px * s),
        valid_close_kernel=px(base.valid_close_kernel, 3) | 1,
        reliable_edge_margin_px=px(base.reliable_edge_margin_px),
        dilate_kernel_size=px(base.dilate_kernel_size, 3) | 1,
        bad_dilate_ksize=px(base.bad_dilate_ksize, 3) | 1,
        reliable_smooth_sigma_px=max(0.8, base.reliable_smooth_sigma_px * s),
        unreliable_smooth_sigma_px=max(1.5, base.unreliable_smooth_sigma_px * s),
        frontier_zero_band_px=px(base.frontier_zero_band_px, 4),
        hole_neighborhood_px=px(base.hole_neighborhood_px, 3) | 1,
        hole_min_dist_from_reliable_edge_px=px(base.hole_min_dist_from_reliable_edge_px),
        inpaint_radius=px(base.inpaint_radius, 2),
        bad_inpaint_radius=px(base.bad_inpaint_radius, 2),
        global_shift_blur_sigma=max(1.0, base.global_shift_blur_sigma * s),
        ecc_gauss_filt=max(1.0, base.ecc_gauss_filt * s),
        dc_exclusion=max(3, int(round(base.dc_exclusion * s * 2))),
        patch_half_width_bins=base.patch_half_width_bins,
        unwrap_cg_iters=base.unwrap_cg_iters,
        inpaint_iters=max(16, int(base.inpaint_iters * s * 2)),
    )


def synthetic_pair(height: int, width: int, cfg: FTPConfig,
                   period_px: float = 12.0, dent_depth_rad: float = 0.8,
                   seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """(ref_bgr, def_bgr) uint8 frames: carrier grating + Gaussian dent phase
    shift in the deformed frame."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float64)
    carrier = 2.0 * np.pi * xx / period_px

    cx, cy, r = circle_from_3_points(cfg.outer_circle_p1, cfg.outer_circle_p2,
                                     cfg.outer_circle_p3)
    dent = dent_depth_rad * np.exp(-(((xx - cx) ** 2 + (yy - cy) ** 2) / (2 * (0.25 * r) ** 2)))

    illum = 160.0 + 30.0 * np.exp(-(((xx - width / 2) ** 2 + (yy - height / 2) ** 2)
                                    / (2 * (0.8 * max(height, width)) ** 2)))

    def frame(phase_extra):
        sig = illum * (1.0 + 0.35 * np.cos(carrier + phase_extra))
        sig = sig + rng.normal(scale=1.5, size=sig.shape)
        g = np.clip(sig, 0, 255).astype(np.uint8)
        return np.stack([g, g, g], axis=-1)

    return frame(0.0), frame(dent)
