"""Frozen configuration dataclasses for the force and temperature paths.

A field-for-field copy of the JAX package's ``FTPConfig`` and
``TempConfig`` (each with its ``deploy()`` preset), ``ForceConfig`` and
``SessionConfig``, and the reference artifacts' default paths under a data
root; the port cannot
import them because importing the JAX package may load jax.  ``tests/test_torch_config.py``
compares every field name and default with the JAX dataclasses, so drift is
caught.  The field documentation lives in the JAX package.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

Point = Tuple[int, int]


@dataclass(frozen=True)
class FTPConfig:
    """Fourier-transform-profilometry core configuration
    (the JAX package's ``config.FTPConfig``)."""

    outer_circle_p1: Point = (1873, 1703)
    outer_circle_p2: Point = (1599, 707)
    outer_circle_p3: Point = (2575, 950)
    roi_erode_px: int = 0

    sideband_method: str = "patch_shift"
    patch_half_width_bins: int = 10
    patch_window: str = "hann"
    band_radius: float = 8.0
    gauss_trunc_radius: float = 24.0
    dc_exclusion: int = 10
    n_fft_peaks: int = 12
    peak_method: str = "topk"
    demod_rfft_min_px: int = 0

    fft_pad_px: int = 96
    pre_blur_sigma_px: float = 1.5
    illum_sigma_px: float = 45.0
    remove_mean_after_apod: bool = True
    use_circular_apodization: bool = True
    apod_taper_px: int = 120
    use_hann_window: bool = False

    bad_pixel_enable: bool = True
    bad_intensity_percentile: float = 99.9
    bad_gradient_percentile: float = 99.7
    bad_dilate_ksize: int = 5
    bad_dilate_iters: int = 1
    bad_inpaint_radius: int = 3

    amp_valid_percentile: float = 25.0
    quality_smooth_sigma_px: float = 6.0
    reliable_keep_largest_cc: bool = True
    reliable_edge_margin_px: int = 6
    valid_morph_close: bool = True
    valid_close_kernel: int = 7
    valid_close_iters: int = 1

    poly_order: int = 2
    use_two_pass_detrend: bool = True
    contact_core_percentile: float = 8.0
    contact_percentile: float = 92.0
    dilate_kernel_size: int = 15
    dilate_iters: int = 2
    min_contact_frac: float = 0.002
    max_contact_frac: float = 0.40
    remove_global_plane_before_detrend: bool = True
    plane_order_for_removal: int = 1

    reliable_smooth_sigma_px: float = 2.5
    unreliable_base_value: float = 0.0
    fill_internal_holes_in_reliable: bool = True
    hole_neighborhood_px: int = 11
    hole_known_fraction: float = 0.70
    hole_min_dist_from_reliable_edge_px: int = 4
    inpaint_radius: int = 5
    smooth_unreliable_region: bool = True
    unreliable_smooth_sigma_px: float = 9.0
    allow_positive_deformation: bool = False
    auto_flip_sign: bool = True

    frontier_zero_enable: bool = True
    frontier_zero_band_px: int = 200
    frontier_zero_curve: str = "smoothstep"

    output_height_in_mm: bool = True
    mm_keep_indentation_negative: bool = False

    filter_small_contact_blobs: bool = True
    contact_blob_min_peak_mm: float = 0.1
    contact_blob_min_peak_rel_frac: float = 1.0 / 3.0
    contact_blob_min_area_px: int = 0
    contact_blob_cand_eps_mm: float = 1e-2

    apply_global_shift: bool = True
    use_ecc_crop_alignment: bool = True
    ecc_warp_mode: str = "euclidean"
    ecc_iters: int = 300
    ecc_eps: float = 1e-7
    ecc_gauss_filt: float = 5.0
    ecc_stride: int = 1
    ecc_sampler: str = "gather"
    ecc_shear_k: int = 4
    ecc_stall_patience: int = 0
    ecc_loop_kernel: bool = False
    ecc_downsample: int = 1
    ecc_downsample_min_px: int = 1024
    ecc_coarse_downsample: int = 4
    ecc_polish_iters: int = 0
    global_shift_blur_sigma: float = 7.0
    global_shift_max_px: int = 96
    global_shift_downsample: int = 1
    global_shift_downsample_min_px: int = 1024
    global_shift_pc_eps: float = 0.0
    global_shift_window_px: int = 0

    use_grating_band_prealign: bool = False
    grating_prealign_band_px: int = 200
    grating_prealign_dilate_reliable_px: int = 0
    grating_prealign_hp_sigma_px: float = 35.0
    grating_prealign_ecc_mode: str = "euclidean"
    grating_prealign_ecc_iters: int = 250
    grating_prealign_ecc_eps: float = 1e-7
    grating_prealign_ecc_gauss_filt: float = 0.0

    force_right_half_plane: bool = True
    prefer_peak_near_center_row: bool = True
    peak_max_dy_from_center: float = 0.12
    carrier_local_search_radius: int = 6
    lock_carrier_to_reference: bool = True
    apply_dk_ramp_correction: bool = True

    unwrap_cg_iters: int = 30
    unwrap_cg_tol: float = 1e-8
    polyfit_kernel: bool = False
    unwrap_method: str = "wls"
    unwrap_downsample: int = 1
    unwrap_downsample_min_px: int = 1024

    percentile_method: str = "sort"
    polyfit_resigma_iters: int = 6
    polyfit_iters: int = 6
    detrend_fold_plane: bool = False
    dc_remove_stat: str = "median"
    conv_vpu: bool = False
    inpaint_iters: int = 64
    distance_metric: str = "chamfer3"
    largest_cc_method: str = "label"
    cc_seed_pool: int = 1

    image_height: int = 2160
    image_width: int = 3840

    def replace(self, **kw) -> "FTPConfig":
        return dataclasses.replace(self, **kw)

    def deploy(self) -> "FTPConfig":
        """The JAX package's latency preset (``FTPConfig.deploy`` of the JAX
        package), value for value; its measurements and reasons are
        documented there and were taken on a TPU."""
        shear_k = max(4, round(12 * self.image_height / 2160))
        return self.replace(percentile_method="hist_pallas", ecc_stride=2,
                            largest_cc_method="seed_edt", ecc_sampler="shear",
                            ecc_shear_k=shear_k, ecc_stall_patience=25,
                            polyfit_resigma_iters=2, unwrap_cg_iters=16,
                            polyfit_iters=4, detrend_fold_plane=True,
                            dc_remove_stat="mean",
                            fill_internal_holes_in_reliable=False,
                            unwrap_method="wls_pallas",
                            ecc_loop_kernel=True,
                            polyfit_kernel=True,
                            ecc_downsample=2,
                            ecc_polish_iters=10,
                            cc_seed_pool=4,
                            inpaint_iters=20,
                            unwrap_downsample=4,
                            peak_method="cascade")


@dataclass(frozen=True)
class ForceConfig:
    """Force-sensor configuration (the JAX package's ``config.ForceConfig``)."""

    grating_pitch_mm: float = 2.0
    depth_eps_mm: float = 0.01
    override_mm_per_px: Optional[float] = None


@dataclass(frozen=True)
class TempConfig:
    """Temperature-sensor configuration (the JAX package's
    ``config.TempConfig``)."""

    outer_circle_p1: Point = (1845, 1818)
    outer_circle_p2: Point = (1517, 623)
    outer_circle_p3: Point = (2687, 914)
    use_inner_circle: bool = False
    inner_circle_p1: Point = (1881, 1749)
    inner_circle_p2: Point = (1579, 665)
    inner_circle_p3: Point = (2616, 936)

    crop_output_to_outer_roi: bool = True
    crop_pad_px: int = 10

    blur_ksize: int = 5

    color_t_min: float = 20.0
    color_t_max: float = 33.0
    color_guard_band: float = 0.5
    switch_margin_c: float = 1.0
    final_t_min: float = 20.0
    final_t_max: float = 75.0

    seg_band_radius: float = 22.0
    seg_dc_exclusion: int = 28
    seg_force_right_half_plane: bool = True
    seg_prefer_peak_near_center_row: bool = True
    seg_peak_max_dy_from_center: float = 0.14
    seg_illum_sigma: float = 20.0
    seg_n_peaks: int = 16
    seg_peak_method: str = "topk"
    seg_bandpass: str = "fft"
    seg_fft: str = "fft2"

    sat_thresh_gray: int = 245
    sat_dilate_ksize: int = 13

    post_close_kx: int = 3
    post_close_ky: int = 31
    post_open_kx: int = 3
    post_open_ky: int = 7

    color_chroma_min: float = 10.0
    color_support_dilate: int = 3

    final_smooth_enable: bool = True
    final_smooth_sigma_across: float = 6.0
    final_smooth_sigma_along: float = 1.0

    use_fused_kernel: bool = False
    percentile_method: str = "sort"
    conv_vpu: bool = False
    wide_inpaint_iters: int = 96
    color_inpaint_iters: int = 48
    rotate_method: str = "gather"
    crop_compute: bool = False

    def deploy(self) -> "TempConfig":
        """The JAX package's latency preset (``TempConfig.deploy`` of the
        JAX package), value for value; its measurements and reasons are
        documented there and were taken on a TPU."""
        return self.replace(percentile_method="hist_pallas", use_fused_kernel=True,
                            wide_inpaint_iters=16, color_inpaint_iters=8,
                            rotate_method="shear", crop_compute=True,
                            conv_vpu=True, seg_peak_method="cascade",
                            seg_bandpass="matmul", seg_fft="rfft2")

    wide_inpaint_radius: int = 7
    color_inpaint_radius: int = 5

    image_height: int = 2160
    image_width: int = 3840

    def replace(self, **kw) -> "TempConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class SessionConfig:
    """Multimodal session-runner configuration (``runner/session.py``)."""

    output_root: str = "./Multimodal_Sensor/run_output"
    save_summary_figures: bool = True
    export_heightmaps: bool = True
    show_3d_interactive: bool = False
    # MultimodalPipeline.step_fused (shared uploads, device reductions)
    # instead of __call__; same outputs
    fused_step: bool = False


# Default locations of the reference calibration artifacts, relative to a
# data root (the JAX ``config.py``'s constants, for ``from_artifacts``).
PHASE_TO_HEIGHT_JSON = "Force/Phase_to_height/calibration_out/calibration_model.json"
HEIGHT_TO_FORCE_JSON = "Force/Height_to_force/calibration_out/calibration_model.json"
TEMP_COLOR_METRICS_JSON = "Temperature/Colored_Model/calibration_out/models_final_summary_metrics.json"
TEMP_BLACK_METRICS_JSON = "Temperature/MixedColorBlack_Model/calibration_out/models_final_summary_metrics.json"
TEMP_COLOR_MODEL_GLOB = "Temperature/Colored_Model/calibration_out/color_model_global_huber_deg*.joblib"
TEMP_WIDE_MODEL_GLOB = "Temperature/MixedColorBlack_Model/calibration_out/black_model_global_huber_deg*.joblib"


def slice_ftp_config(height: int, width: int) -> FTPConfig:
    """The deploy preset scaled to (height, width), as shipped
    (``scaled_ftp_config(height, width).deploy()``)."""
    from vistaf_torch.utils.synthetic import scaled_ftp_config
    return scaled_ftp_config(height, width).deploy()


def _from_dict(cls, d: Dict[str, Any]):
    names = {f.name for f in dataclasses.fields(cls)}
    unknown = set(d) - names
    if unknown:
        raise ValueError(f"unknown {cls.__name__} fields: {sorted(unknown)}")
    # JSON round trips turn the circle points into lists; the frozen
    # dataclass must stay hashable
    return cls(**{k: tuple(v) if isinstance(v, list) else v for k, v in d.items()})


def ftp_config_from_dict(d: Dict[str, Any]) -> FTPConfig:
    """FTPConfig from a field dict, e.g. ``dataclasses.asdict`` of the JAX
    package's config."""
    return _from_dict(FTPConfig, d)


def force_config_from_dict(d: Dict[str, Any]) -> ForceConfig:
    """ForceConfig from a field dict."""
    return _from_dict(ForceConfig, d)


def temp_config_from_dict(d: Dict[str, Any]) -> TempConfig:
    """TempConfig from a field dict, e.g. ``dataclasses.asdict`` of the JAX
    package's config."""
    return _from_dict(TempConfig, d)
