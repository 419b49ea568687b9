"""Synthetic scenes, model weights and resolution-scaled configs (numpy only).

``scaled_ftp_config``, ``synthetic_pair``, ``scaled_temp_config`` and
``synthetic_temp_weights`` are the JAX package's ``utils/synthetic.py``:
the frames are byte-identical and the configs and weights equal for the same
arguments, so the port and the reference run the same scene.
``synthetic_tlc_frame`` and ``synthetic_deploy_temp_weights`` are the
port's own test inputs for the temperature path; ``synthetic_indentation_series``
and ``synthetic_tlc_series`` its seeded calibration series for the trainers
(the tests and ``chip_smoke.py`` write them to files; no pipeline reads them).
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from plainref.calib.temp_weights import TempModelWeights, poly_powers
from plainref.config import FTPConfig, TempConfig
from plainref.ops.geometry import circle_from_3_points, circle_from_3_points_exact


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


def scaled_temp_config(height: int, width: int,
                       base: Optional[TempConfig] = None) -> TempConfig:
    """TempConfig with every pixel-dimension parameter scaled from the
    native 3840x2160 geometry to (height, width)."""
    base = base or TempConfig()
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
        inner_circle_p1=pt(base.inner_circle_p1),
        inner_circle_p2=pt(base.inner_circle_p2),
        inner_circle_p3=pt(base.inner_circle_p3),
        crop_pad_px=px(base.crop_pad_px, 2),
        seg_band_radius=max(3.0, base.seg_band_radius * s),
        seg_dc_exclusion=max(3, int(round(base.seg_dc_exclusion * s))),
        seg_illum_sigma=max(2.0, base.seg_illum_sigma * s),
        sat_dilate_ksize=px(base.sat_dilate_ksize, 3) | 1,
        post_close_ky=px(base.post_close_ky, 3) | 1,
        post_open_ky=px(base.post_open_ky, 3) | 1,
        color_support_dilate=px(base.color_support_dilate, 1),
        final_smooth_sigma_across=max(1.0, base.final_smooth_sigma_across * s),
        final_smooth_sigma_along=max(0.5, base.final_smooth_sigma_along * s),
    )


def synthetic_temp_weights() -> Tuple[TempModelWeights, TempModelWeights]:
    """(color, wide): the JAX package's tiny degree-1 (L,a,b) and
    (L,a,b,gray) models for tests and dry runs."""
    color = TempModelWeights(
        name="color_model", feature_names=("L", "a", "b"),
        scaler_mean=np.array([130.0, 160.0, 90.0]),
        scaler_scale=np.array([27.0, 15.0, 19.0]),
        powers=poly_powers(3, 1), coef=np.array([13.0, 8.0, 4.0, 2.0]),
        intercept=13.0, poly_degree=1)
    wide = TempModelWeights(
        name="wide_model", feature_names=("L", "a", "b", "gray"),
        scaler_mean=np.array([122.0, 128.0, 117.0, 115.0]),
        scaler_scale=np.array([50.0, 3.5, 2.3, 48.0]),
        powers=poly_powers(4, 1), coef=np.array([17.5, 45.0, 1.2, 0.5, -36.0]),
        intercept=17.5, poly_degree=1)
    return color, wide


def synthetic_deploy_temp_weights(seed: int = 0) -> Tuple[TempModelWeights, TempModelWeights]:
    """(color, wide) of the shipped models' form with seeded numbers: WIDE
    degree 3 over (L, a, b, gray), 35 terms; COLOR degree 2 over (L, a, b),
    10 terms, with an isotonic calibrator of 64 sorted knots whose
    outputs span the COLOR validity range (20 to 33 degC).  Coefficients
    shrink with the term degree, so the maps stay in the 20 to 40 degC
    range on 8-bit features."""
    rng = np.random.default_rng(seed)

    def model(name, feats, degree, mean, scale, intercept, size):
        powers = poly_powers(len(feats), degree)
        deg = powers.sum(axis=1)
        coef = rng.normal(scale=size, size=len(powers)) / (1.0 + deg) ** 2
        return TempModelWeights(
            name=name, feature_names=feats, scaler_mean=np.asarray(mean, np.float64),
            scaler_scale=np.asarray(scale, np.float64), powers=powers, coef=coef,
            intercept=float(intercept), poly_degree=degree)

    wide = model("wide_model", ("L", "a", "b", "gray"), 3, [130.0, 150.0, 150.0, 110.0],
                 [60.0, 25.0, 25.0, 55.0], 26.0, 4.0)
    color = model("color_model", ("L", "a", "b"), 2, [140.0, 160.0, 150.0],
                  [50.0, 25.0, 25.0], 27.0, 6.0)
    iso_x = np.sort(rng.uniform(15.0, 40.0, 64))
    iso_y = np.sort(rng.uniform(20.0, 33.0, 64))
    return dataclasses.replace(color, iso_x=iso_x, iso_y=iso_y), wide


def synthetic_tlc_frame(height: int, width: int, cfg: TempConfig,
                        seed: int = 0) -> np.ndarray:
    """A seeded BGR uint8 scene of thermochromic stripes, for tests and the
    chip smoke test (no pipeline reads it): a grating tilted by 8 degrees
    whose period (max(10, width / 240) px) puts the carrier outside the
    ``seg_dc_exclusion`` notch and inside the ``seg_peak_max_dy_from_center``
    row band; its dark half is near-black and grey, its light half coloured
    with a hue that follows a smooth radial hot spot inside the ROI (LAB
    chroma well above ``color_chroma_min``); a dozen white specks (gray 255
    >= ``sat_thresh_gray``) inside the ROI give the saturation mask and the
    WIDE inpaint holes to fill; mild illumination falloff and noise."""
    rng = np.random.default_rng(seed)
    cx, cy, r = circle_from_3_points_exact(cfg.outer_circle_p1, cfg.outer_circle_p2,
                                           cfg.outer_circle_p3)
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float32)
    theta = np.deg2rad(8.0)
    period = max(10.0, width / 240.0)
    phase = (2.0 * np.pi / period) * (np.float32(np.cos(theta)) * xx
                                      + np.float32(np.sin(theta)) * yy)
    light = np.clip(0.5 + 1.5 * np.cos(phase), 0.0, 1.0)[..., None]
    del phase
    # hot spot: hue 0 (red, cold) at the rim to ~0.7 (blue, hot) at its centre
    hx, hy = cx + 0.25 * r, cy - 0.2 * r
    d2 = ((xx - hx) ** 2 + (yy - hy) ** 2) / np.float32((0.6 * r) ** 2)
    hue = 0.7 * np.exp(-d2)
    del d2
    ang = 2.0 * np.pi * hue
    # a saturated colour wheel in BGR around a mid-grey
    color = np.stack([150.0 + 90.0 * np.cos(ang - 4.19),
                      150.0 + 90.0 * np.cos(ang - 2.09),
                      150.0 + 90.0 * np.cos(ang)], axis=-1).astype(np.float32)
    del ang, hue
    dark = np.float32(28.0)
    illum = (1.0 - 0.15 * ((xx - width / 2) ** 2 + (yy - height / 2) ** 2)
             / np.float32(max(height, width) ** 2))[..., None]
    img = (dark + light * (color - dark)) * illum
    del color, light, illum
    img += rng.normal(scale=2.0, size=img.shape).astype(np.float32)
    # white specks inside the ROI
    n = 12
    rad = max(2.0, 0.004 * r)
    a = rng.uniform(0.0, 2.0 * np.pi, n)
    d = 0.8 * r * np.sqrt(rng.uniform(0.0, 1.0, n))
    for sx, sy in zip(cx + d * np.cos(a), cy + d * np.sin(a)):
        y0, y1 = int(max(0, sy - rad - 1)), int(min(height, sy + rad + 2))
        x0, x1 = int(max(0, sx - rad - 1)), int(min(width, sx + rad + 2))
        spot = (yy[y0:y1, x0:x1] - sy) ** 2 + (xx[y0:y1, x0:x1] - sx) ** 2 <= rad * rad
        img[y0:y1, x0:x1][spot] = 255.0
    return np.clip(np.round(img), 0, 255).astype(np.uint8)


def synthetic_indentation_series(height: int, width: int, cfg: FTPConfig,
                                 dent_depths_rad: Sequence[float], period_px: float = 12.0,
                                 seed: int = 0) -> Tuple[np.ndarray, List[np.ndarray]]:
    """(ref_bgr, [def_bgr, ...]) uint8: ``synthetic_pair``'s scene (carrier
    grating, Gaussian dent at the ROI centre, illumination falloff) with the
    dent at each of ``dent_depths_rad`` in turn, for the force trainers.
    Each frame draws its own float32 noise (scale 1.5, as
    ``synthetic_pair``'s): windows of one shared field would be shifted
    copies of each other, which the phase correlation aligns on."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float64)
    carrier = 2.0 * np.pi * xx / period_px
    cx, cy, r = circle_from_3_points(cfg.outer_circle_p1, cfg.outer_circle_p2,
                                     cfg.outer_circle_p3)
    dent = np.exp(-(((xx - cx) ** 2 + (yy - cy) ** 2) / (2 * (0.25 * r) ** 2)))
    illum = 160.0 + 30.0 * np.exp(-(((xx - width / 2) ** 2 + (yy - height / 2) ** 2)
                                    / (2 * (0.8 * max(height, width)) ** 2)))
    del yy, xx

    def frame(phase_extra):
        sig = illum * (1.0 + 0.35 * np.cos(carrier + phase_extra))
        sig += 1.5 * rng.standard_normal(sig.shape, dtype=np.float32)
        g = np.clip(sig, 0, 255).astype(np.uint8)
        return np.stack([g, g, g], axis=-1)

    return frame(0.0), [frame(d * dent) for d in dent_depths_rad]


def synthetic_tlc_series(height: int, width: int, temps: Sequence[float],
                         t_span: Optional[Tuple[float, float]] = None,
                         jitter: float = 1.0, seed: int = 0) -> Iterator[np.ndarray]:
    """Seeded BGR uint8 frames of one colour each, one per entry of
    ``temps``, the colour following the temperature, as
    ``tests/test_trainer_plots.py::_write_series`` draws them, for the
    temperature trainers and the pretest: the colour moves linearly in LAB
    (L 65 -> 45, a -10 -> 40, b 35 -> -15) from the low end of ``t_span``
    (default: the range of ``temps``) to the high end, so the temperature is
    a linear function of the mean LAB features; each frame adds a seeded
    colour jitter (scale ``jitter`` LAB units, a frame's lighting; 0 for a
    series that settles, as the pretest's), which keeps the
    trainers' cross-validated fits of many terms on few frames from
    beating the linear model by their rounding; and per-pixel noise (scale
    2) from one field drawn for the series, read at a seeded offset a frame:
    a 4K series draws 25 M normals once, not once a frame."""
    import cv2
    rng = np.random.default_rng(seed)
    lo, hi = t_span if t_span is not None else (min(temps), max(temps))
    pad = 16
    field = rng.standard_normal((height + pad, width + pad, 3), dtype=np.float32)
    field *= np.float32(2.0)
    offs = rng.integers(0, pad + 1, size=(len(temps), 2))
    shake = rng.normal(scale=1.0, size=(len(temps), 3)) * jitter
    lab_lo, lab_hi = np.array([65.0, -10.0, 35.0]), np.array([45.0, 40.0, -15.0])
    for k, t in enumerate(temps):
        u = float(np.clip((t - lo) / (hi - lo), 0.0, 1.0)) if hi > lo else 0.0
        lab = (lab_lo + u * (lab_hi - lab_lo) + shake[k]).astype(np.float32)
        bgr = cv2.cvtColor(lab.reshape(1, 1, 3), cv2.COLOR_LAB2BGR).reshape(3) * 255.0
        oy, ox = offs[k]
        img = np.float32(bgr) + field[oy:oy + height, ox:ox + width]
        yield np.clip(np.round(img), 0, 255).astype(np.uint8)
