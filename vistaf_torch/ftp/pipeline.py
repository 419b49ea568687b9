"""Full FTP forward pass: frame pair -> calibrated mm depth map
(JAX ``ftp/pipeline.py``).

Stages in order: gray conversion, full-frame phase-correlation shift, ROI
crop, ECC crop alignment (K5, or the pooled and coarse-to-fine solves with
K4; the gather sampler's host loop), demodulation of the pair (percentile
thresholds, K3), the reliable mask (a percentile, close, dominant or
largest component, distance erode), wrapped phase difference, WLS unwrap
(K6, or the PCG, pooled or not), the unfolded plane removal, two-pass IRLS
detrend (K7, or the IRLS with K2, histogram or sort percentiles),
smoothing, sign flip, the internal-hole fill (K3), frontier taper,
unreliable-region fill, clamp, mm conversion and the contact-blob filter.
Percentiles are K1 under ``hist_pallas``, sorts under ``sort`` and the
histogram ladders of ``ops/percentile.py`` under ``hist``.  Each kernel is
taken where the JAX package takes its Pallas kernel on a TPU, by shape (the
routing rule in ``kernels/__init__.py``).  The pipeline owns its static
geometry (circle mask, eroded ROI, apodization, Hann window) and
blur/DCT/DFT matrices as tensors on its device, built once.

It runs the JAX package's parity preset, the CLI's default numerics
(``FTPConfig()`` at native 2160x3840 and ``scaled_ftp_config(h, w)``: sort
percentiles, the gather-sampler ECC, the full-``fft2`` demod with the
'topk' carrier search and median DC removal, the largest component, the
hole fill, the unfolded plane removal, the full-resolution unwrap with the
FFT-based DCT from 512 px; K3 is its only kernel), and its deploy preset as
shipped (``scaled_ftp_config(480, 640).deploy()``, ``FTPConfig().deploy()``),
and the parity preset with ``percentile_method="hist"`` (the configuration
of the JAX package's whole-limb tests; K3 is its only kernel too).
Configurations the port does not run yet raise at construction: see
``FTPPipeline.check_config``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from vistaf_torch import use_full_fp32
from vistaf_torch.calib import scalar_models
from vistaf_torch.config import FTPConfig
from vistaf_torch.ftp import demod
from vistaf_torch.ftp.demod import ftp_complex_demod_pair
from vistaf_torch.kernels import unwrap_kernel
from vistaf_torch.ops import geometry
from vistaf_torch.ops.color import bgr_to_gray
from vistaf_torch.ops.components import (dominant_component, filter_components_by_peak,
                                         largest_component)
from vistaf_torch.ops.consts import DeviceConsts
from vistaf_torch.ops.distance import erode_by_distance, get_distance_fn
from vistaf_torch.ops.filters import (box_filter, gaussian_blur, hanning_window,
                                      masked_gaussian_smooth)
from vistaf_torch.ops.inpaint import inpaint_within_roi
from vistaf_torch.ops.morphology import close as morph_close
from vistaf_torch.ops.morphology import dilate, ellipse_kernel
from vistaf_torch.ops.percentile import get_percentile_fn, masked_max
from vistaf_torch.ops.polyfit import robust_polyfit2d
from vistaf_torch.ops.registration import ecc_align, phase_correlate
from vistaf_torch.ops.unwrap import unwrap_wls
from vistaf_torch.ops.warp import (translate_bilinear, warp_affine_inverse_map,
                                   warp_affine_inverse_shear)

STAGES = ("align", "demod", "reliable", "unwrap", "detrend", "assemble")


@dataclass(frozen=True)
class FTPGeometry:
    """Static crop/ROI geometry resolved from an FTPConfig on the host."""
    cx_full: int
    cy_full: int
    r_full: int
    bbox: tuple          # (x1, x2, y1, y2)
    cx_local: int
    cy_local: int
    r_local: int
    crop_h: int
    crop_w: int

    @staticmethod
    def from_config(cfg: FTPConfig) -> "FTPGeometry":
        cx, cy, r = geometry.circle_from_3_points(
            cfg.outer_circle_p1, cfg.outer_circle_p2, cfg.outer_circle_p3)
        bbox = geometry.roi_crop_bbox(cx, cy, r, cfg.image_height, cfg.image_width)
        cxl, cyl, rl = geometry.local_circle(cx, cy, r, bbox)
        x1, x2, y1, y2 = bbox
        return FTPGeometry(cx, cy, r, bbox, cxl, cyl, rl, y2 - y1, x2 - x1)


def detect_internal_holes(container: torch.Tensor, known: torch.Tensor, ksize: int,
                          frac_thr: float, min_dist_edge_px: float, consts: DeviceConsts,
                          metric: str = "chamfer3") -> torch.Tensor:
    """The reference's ``compute_internal_holes_within_mask``: unknown
    pixels inside ``container`` whose (k x k) neighbourhood is mostly known
    (box-filter count fraction >= frac_thr) and that lie at least
    ``min_dist_edge_px`` inside the container's edge."""
    container = container.to(torch.bool)
    known = known.to(torch.bool) & container
    k = max(3, int(ksize) | 1)
    frac = (box_filter(known.to(torch.float32), k, consts)
            / (box_filter(container.to(torch.float32), k, consts) + 1e-6))
    dist = get_distance_fn(metric)(container, max_dist=int(min_dist_edge_px) + 4)
    return container & ~known & (frac >= float(frac_thr)) & (dist >= float(min_dist_edge_px))


def _curve01(t: torch.Tensor, kind: str) -> torch.Tensor:
    """Frontier transition curves."""
    t = torch.clamp(t, 0.0, 1.0)
    if kind == "linear":
        return t
    if kind == "cosine":
        return 0.5 - 0.5 * torch.cos(np.pi * t)
    return t * t * (3.0 - 2.0 * t)


def unwrap_route(cfg: FTPConfig, shape) -> Tuple[str, Tuple[int, int]]:
    """The JAX package's unwrap dispatch (``ftp/pipeline.py:454-473``) for a
    crop of ``shape``: ('pooled', the pooled solve grid) when
    ``unwrap_downsample`` engages, else ('k6', shape) for ``wls_pallas``
    while K6's budget holds, else ('plain', shape)."""
    h, w = shape
    d = int(cfg.unwrap_downsample)
    if d > 1 and min(h, w) >= cfg.unwrap_downsample_min_px:
        return "pooled", (-(-h // d), -(-w // d))
    if cfg.unwrap_method == "wls_pallas" and unwrap_kernel.fits((h, w)):
        return "k6", (h, w)
    return "plain", (h, w)


class FTPPipeline:
    """Frame pair -> mm depth map on one device::

        pipe = FTPPipeline(cfg, p2h_model)     # on the card; device="cpu" runs
        out = pipe(ref_bgr_u8, def_bgr_u8)     # the kernels' plain versions

    ``stop_after`` truncates the forward after a named stage (one of
    ``STAGES``) and returns ``{'x': ...}``, as the JAX pipeline does."""

    def __init__(self, cfg: FTPConfig, p2h_model: Dict[str, Any],
                 use_negated_height: bool = True, debug_outputs: bool = False,
                 stop_after: Optional[str] = None, *, device="cuda"):
        if stop_after is not None and stop_after not in STAGES:
            raise ValueError(f"stop_after must be one of {STAGES}, got {stop_after!r}")
        self.check_config(cfg)
        self.cfg = cfg
        self.p2h_model = p2h_model
        self.use_neg = use_negated_height
        self.debug_outputs = debug_outputs
        self.stop_after = stop_after
        self.device = torch.device(device)
        if self.device.type == "cuda":
            use_full_fp32()
        self.consts = DeviceConsts(self.device)
        self.geom = g = FTPGeometry.from_config(cfg)

        self._circ_mask = geometry.circular_mask(g.crop_h, g.crop_w, g.cx_local,
                                                 g.cy_local, g.r_local)
        r_valid = max(0, g.r_local - int(cfg.roi_erode_px))
        self._roi_eroded = geometry.circular_mask(g.crop_h, g.crop_w, g.cx_local,
                                                  g.cy_local, r_valid)
        self._apo = (geometry.circular_apodization(
            g.crop_h, g.crop_w, g.cx_local, g.cy_local, g.r_local, cfg.apod_taper_px)
            if cfg.use_circular_apodization else None)
        self._hann_full = hanning_window(cfg.image_height, cfg.image_width)
        dev = self.device
        self.circ = torch.as_tensor(self._circ_mask, device=dev)
        self.roi = torch.as_tensor(self._roi_eroded, device=dev)
        self.apo = torch.as_tensor(self._apo, device=dev) if self._apo is not None else None
        self.hann_full = torch.as_tensor(self._hann_full, device=dev)

    @staticmethod
    def check_config(cfg: FTPConfig) -> None:
        """Raise NotImplementedError, naming the knobs, for a configuration
        outside the ported paths.  The parity preset runs (``FTPConfig()``,
        ``scaled_ftp_config(h, w)``: sort percentiles, the gather-sampler
        ECC, the full-``fft2`` demod, the largest component, the hole fill,
        the unfolded plane removal, the FFT-based DCT), so does it with the
        ``hist`` percentiles (the JAX package's whole-limb test
        configuration), and so do both deploy presets as shipped.  The
        percentile methods are the JAX package's: ``sort``, ``hist`` and
        ``hist_pallas`` (``hist_rows`` and ``bisect`` are not methods there
        either).  Still unported: the Gaussian sideband, the unlocked demod
        and the Hann window (``demod.check_config``), the ECC's translation
        and affine modes and its gather sampler at a stride, the
        single-pass detrend and the grating-band prealignment.  Never
        ported: the pooled and the windowed global shift
        (``global_shift_downsample``, ``global_shift_pc_eps``,
        ``global_shift_window_px``), measured on the goldens and rejected
        by the JAX package (its ``docs/PERF.md``, the pooled global-shift
        incident and the rejected round-5 experiments)."""
        demod.check_config(cfg)
        unported = {
            "percentile_method": cfg.percentile_method not in ("sort", "hist", "hist_pallas"),
            "ecc_warp_mode/ecc_sampler": cfg.use_ecc_crop_alignment and (
                cfg.ecc_warp_mode != "euclidean" or cfg.ecc_sampler not in ("shear", "gather")
                or (cfg.ecc_sampler == "gather" and cfg.ecc_stride != 1)),
            "global_shift_downsample": cfg.global_shift_downsample > 1 and min(
                cfg.image_height, cfg.image_width) >= cfg.global_shift_downsample_min_px,
            "global_shift_window_px": cfg.global_shift_window_px > 0,
            "use_grating_band_prealign": cfg.use_grating_band_prealign,
            "unwrap_method": cfg.unwrap_method not in ("wls", "wls_pallas"),
            "largest_cc_method": cfg.reliable_keep_largest_cc
            and cfg.largest_cc_method not in ("seed_edt", "label"),
            "use_two_pass_detrend": not cfg.use_two_pass_detrend,
        }
        bad = [k for k, v in unported.items() if v]
        if bad:
            raise NotImplementedError(f"vistaf_torch does not port {bad} yet")

    # ------------------------------------------------------------------
    def __call__(self, ref_bgr, def_bgr) -> Dict[str, Any]:
        return self.to_host(self.forward(self.upload(ref_bgr), self.upload(def_bgr)))

    def upload(self, frame) -> torch.Tensor:
        """The frame on the pipeline's device: a numpy array is copied
        there, a tensor already there passes through untouched."""
        if isinstance(frame, torch.Tensor):
            return frame.to(self.device)
        return torch.as_tensor(np.ascontiguousarray(frame), device=self.device)

    def to_host(self, out: Dict[str, torch.Tensor]) -> Dict[str, Any]:
        res = {k: v.cpu().numpy() for k, v in out.items()}
        if self.stop_after is not None:
            return res
        res["roi_eroded_crop"] = self._roi_eroded
        res["circ_mask_crop"] = self._circ_mask
        res["crop_bbox"] = self.geom.bbox
        res["estimated_grating_period_px"] = float(res.pop("est_period_px"))
        return res

    # ------------------------------------------------------------------
    def _reliable_mask(self, dref, ddef, roi, pctl):
        """Smoothed amplitude-product quality, percentile threshold inside
        the ROI, morphological close, dominant component, distance erode."""
        cfg = self.cfg
        quality = dref.amp * ddef.amp
        if cfg.quality_smooth_sigma_px > 0:
            quality = gaussian_blur(quality, cfg.quality_smooth_sigma_px, self.consts)
        amp_thr = pctl(quality, roi, cfg.amp_valid_percentile)
        reliable = roi & (quality >= amp_thr) & torch.isfinite(quality)
        if cfg.valid_morph_close:
            ksz = max(3, cfg.valid_close_kernel | 1)
            reliable = morph_close(reliable, ellipse_kernel(ksz, ksz),
                                   iterations=cfg.valid_close_iters) & roi
        if cfg.reliable_keep_largest_cc and cfg.largest_cc_method == "seed_edt":
            reliable = dominant_component(reliable, seed_pool=int(cfg.cc_seed_pool)) & roi
        elif cfg.reliable_keep_largest_cc:
            reliable = largest_component(reliable) & roi
        if cfg.reliable_edge_margin_px > 0:
            reliable = erode_by_distance(reliable, cfg.reliable_edge_margin_px,
                                         metric=cfg.distance_metric)
        return reliable, quality

    def _polyfit(self, z, mask, order):
        cfg = self.cfg
        return robust_polyfit2d(z, mask, order=order, iters=cfg.polyfit_iters,
                                resigma_iters=cfg.polyfit_resigma_iters,
                                fused=cfg.polyfit_kernel,
                                percentile_method=cfg.percentile_method)[1]

    def _pool_crop(self, crop01, d):
        """d x d mean-pooled crop pair, its circle mask (pooled mean > 0.5)
        and the shear reach max(4, ceil(K / d))."""
        g = self.geom
        hh, ww = (g.crop_h // d) * d, (g.crop_w // d) * d
        pooled = crop01[:, :hh, :ww].reshape(2, hh // d, d, ww // d, d).mean(dim=(2, 4))
        circ_p = self.circ[:hh, :ww].to(torch.float32).reshape(
            hh // d, d, ww // d, d).mean(dim=(1, 3)) > 0.5
        return pooled, circ_p, max(4, -(-self.cfg.ecc_shear_k // d))

    def _ecc(self, crop01):
        """ECC crop alignment: on the ``ecc_downsample`` pooled crop when it
        engages (translations scaled back up), seeded by a coarse solve on
        the ``ecc_coarse_downsample`` grid when ``ecc_polish_iters`` > 0."""
        cfg, g = self.cfg, self.geom
        kw = dict(mode=cfg.ecc_warp_mode, eps=cfg.ecc_eps, stride=cfg.ecc_stride,
                  sampler=cfg.ecc_sampler, stall_patience=cfg.ecc_stall_patience)
        ds = int(cfg.ecc_downsample)
        use_ds = ds > 1 and min(g.crop_h, g.crop_w) >= cfg.ecc_downsample_min_px
        cds = int(cfg.ecc_coarse_downsample)
        use_c2f = (use_ds and int(cfg.ecc_polish_iters) > 0 and cds > ds
                   and cfg.ecc_warp_mode == "euclidean")
        p_seed = None
        if use_c2f:
            pooled_c, circ_c, k_c = self._pool_crop(crop01, cds)
            warp_c, _, _ = ecc_align(pooled_c[0], pooled_c[1], circ_c,
                                     max_iters=cfg.ecc_iters, shear_k=k_c,
                                     loop_kernel=False, **kw)
            theta_c = torch.atan2(warp_c[1, 0], warp_c[0, 0])
            p_seed = torch.stack([theta_c, warp_c[0, 2] * (float(cds) / float(ds)),
                                  warp_c[1, 2] * (float(cds) / float(ds))])
        if use_ds:
            pooled, circ_p, shear_k = self._pool_crop(crop01, ds)
            ecc_in0, ecc_in1, ecc_mask = pooled[0], pooled[1], circ_p
        else:
            ecc_in0, ecc_in1, ecc_mask = crop01[0], crop01[1], self.circ
            shear_k = cfg.ecc_shear_k
        warp, rho, it = ecc_align(
            ecc_in0, ecc_in1, ecc_mask,
            max_iters=int(cfg.ecc_polish_iters) if use_c2f else cfg.ecc_iters,
            shear_k=shear_k, loop_kernel=cfg.ecc_loop_kernel, p_init=p_seed, **kw)
        if use_ds:
            warp = torch.cat([warp[:, :2], warp[:, 2:] * float(ds)], dim=1)
        return warp, rho, it

    def _unwrap(self, phase_wrapped, reliable):
        """The pooled PCG, K6 or the plain PCG, as ``unwrap_route`` says."""
        cfg = self.cfg
        kind, _ = unwrap_route(cfg, tuple(phase_wrapped.shape))
        kw = dict(cg_iters=cfg.unwrap_cg_iters, tol=cfg.unwrap_cg_tol)
        if kind == "pooled":
            return unwrap_wls(phase_wrapped, reliable, self.consts,
                              downsample=int(cfg.unwrap_downsample), **kw)
        if kind == "k6":
            return unwrap_kernel.unwrap_wls(phase_wrapped, reliable, self.consts, **kw)
        return unwrap_wls(phase_wrapped, reliable, self.consts, **kw)

    def forward(self, ref_bgr: torch.Tensor, def_bgr: torch.Tensor
                ) -> Dict[str, torch.Tensor]:
        """The forward graph on device tensors (BGR uint8 frames)."""
        cfg = self.cfg
        consts = self.consts
        x1, x2, y1, y2 = self.geom.bbox
        pctl = get_percentile_fn(cfg.percentile_method)
        roi, apo = self.roi, self.apo
        dev = self.device

        gray_pair = bgr_to_gray(torch.stack([ref_bgr, def_bgr]))
        ref_gray_full, def_gray_full = gray_pair[0], gray_pair[1]

        # --- global shift: full-frame phase correlation of the blurred pair
        gs_dx = torch.zeros((), device=dev)
        gs_dy = torch.zeros((), device=dev)
        if cfg.apply_global_shift:
            blur_pair = gaussian_blur(gray_pair, cfg.global_shift_blur_sigma, consts)
            gs_dx, gs_dy, _ = phase_correlate(blur_pair[0], blur_pair[1], self.hann_full)
            def_gray_full = translate_bilinear(def_gray_full, gs_dx, gs_dy,
                                               max_shift=cfg.global_shift_max_px)

        ref_gray = ref_gray_full[y1:y2, x1:x2]
        def_gray = def_gray_full[y1:y2, x1:x2]

        # --- ECC crop alignment
        ecc_warp = torch.tensor([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]], device=dev)
        ecc_rho = torch.full((), float("nan"), device=dev)
        ecc_it = torch.zeros((), dtype=torch.int32, device=dev)
        if cfg.use_ecc_crop_alignment:
            crop01 = torch.stack([ref_gray, def_gray]) / 255.0
            if cfg.ecc_gauss_filt and cfg.ecc_gauss_filt > 0:
                crop01 = gaussian_blur(crop01, cfg.ecc_gauss_filt, consts)
            ecc_warp, ecc_rho, ecc_it = self._ecc(crop01)
            if cfg.ecc_sampler == "shear":
                def_gray = warp_affine_inverse_shear(def_gray, ecc_warp, K=cfg.ecc_shear_k)
            else:
                def_gray = warp_affine_inverse_map(def_gray, ecc_warp, border="reflect")
        if self.stop_after == "align":
            return {"x": def_gray}

        # --- demodulation, carrier locked to the reference peak
        dref, ddef = ftp_complex_demod_pair(ref_gray, def_gray, apo, cfg, consts)
        hf, wf = dref.fft_shape
        if self.stop_after == "demod":
            return {"x": torch.abs(ddef.complex_demod) + dref.amp}

        # --- reliable mask
        reliable, quality = self._reliable_mask(dref, ddef, roi, pctl)
        if self.stop_after == "reliable":
            return {"x": reliable.to(torch.float32) * quality}

        # --- wrapped phase difference (the carrier is locked: no dk ramp)
        ratio = ddef.complex_demod * torch.conj(dref.complex_demod)
        phase_wrapped = torch.angle(ratio).to(torch.float32)

        # --- unwrap
        phase_unwrapped = self._unwrap(phase_wrapped, reliable)
        if self.stop_after == "unwrap":
            return {"x": phase_unwrapped}

        # --- global plane removal, unless the quadratic detrend absorbs it
        if cfg.remove_global_plane_before_detrend and not (
                cfg.detrend_fold_plane and cfg.poly_order >= cfg.plane_order_for_removal):
            phase_unwrapped = phase_unwrapped - self._polyfit(
                phase_unwrapped, reliable, cfg.plane_order_for_removal)

        # --- two-pass detrend
        fit0 = self._polyfit(phase_unwrapped, reliable, cfg.poly_order)
        abs_res = torch.abs(phase_unwrapped - fit0)
        thrs = pctl(abs_res, reliable, (cfg.contact_percentile, 95.0, 98.0))
        thr, thr95, thr98 = thrs[0], thrs[1], thrs[2]
        contact = (abs_res >= thr) & reliable & torch.isfinite(abs_res)
        frac = contact.sum() / torch.clamp(reliable.sum(), min=1)
        thr2 = torch.where(frac < cfg.min_contact_frac, thr95,
                           torch.where(frac > cfg.max_contact_frac, thr98, thr))
        contact = (abs_res >= thr2) & reliable & torch.isfinite(abs_res)
        contact_d = dilate(contact, ellipse_kernel(cfg.dilate_kernel_size,
                                                   cfg.dilate_kernel_size),
                           iterations=cfg.dilate_iters) & reliable
        background = reliable & ~contact_d
        bg_small = background.sum() < 0.15 * reliable.sum()
        background = torch.where(bg_small, reliable, background)
        phase_detrended = phase_unwrapped - self._polyfit(phase_unwrapped, background,
                                                          cfg.poly_order)
        phase_zeroed = phase_detrended - pctl(phase_detrended, background, 50.0)
        if self.stop_after == "detrend":
            return {"x": phase_zeroed}

        height_map = phase_zeroed
        # --- reliable-only smoothing
        if cfg.reliable_smooth_sigma_px > 0:
            height_map = masked_gaussian_smooth(
                height_map, reliable & torch.isfinite(height_map),
                cfg.reliable_smooth_sigma_px, consts)

        # --- auto sign flip
        if cfg.auto_flip_sign:
            core_thr = pctl(height_map, reliable, cfg.contact_core_percentile)
            core = reliable & torch.isfinite(height_map) & (height_map <= core_thr)
            med_core = pctl(height_map, core, 50.0)
            flip = torch.where(core.any() & (med_core > 0), -1.0, 1.0)
            height_map = height_map * flip

        known_height = reliable & torch.isfinite(height_map)
        height_rel_filled = torch.where(known_height, height_map, float("nan"))

        # --- internal holes: detected and filled unconditionally, as in the
        # JAX graph (under the WLS unwrap the candidate set is usually empty)
        if cfg.fill_internal_holes_in_reliable:
            cand = detect_internal_holes(
                reliable, known_height, cfg.hole_neighborhood_px, cfg.hole_known_fraction,
                cfg.hole_min_dist_from_reliable_edge_px, consts, metric=cfg.distance_metric)
            tmp = torch.where(known_height, height_map, pctl(height_map, known_height, 50.0))
            filled = inpaint_within_roi(tmp, reliable, cand, iters=cfg.inpaint_iters)
            height_rel_filled = torch.where(cand & torch.isfinite(filled), filled,
                                            height_rel_filled)
        output_reliable = reliable & torch.isfinite(height_rel_filled)
        dist_fn = get_distance_fn(cfg.distance_metric)
        band = cfg.frontier_zero_band_px
        base = cfg.unreliable_base_value

        # --- frontier inside taper
        if cfg.frontier_zero_enable and band > 0:
            dist_in = dist_fn(output_reliable, max_dist=band + 4)
            wgt = _curve01(torch.clamp(dist_in - 1.0, min=0.0) / max(1e-6, float(band)),
                           cfg.frontier_zero_curve)
            inside = output_reliable & torch.isfinite(height_rel_filled)
            height_rel_filled = torch.where(
                inside, base + (height_rel_filled - base) * wgt, height_rel_filled)

        # --- assemble
        height_final = torch.where(roi, torch.tensor(base, dtype=torch.float32, device=dev),
                                   float("nan"))
        height_final = torch.where(output_reliable, height_rel_filled, height_final)
        if cfg.smooth_unreliable_region and cfg.unreliable_smooth_sigma_px > 0:
            smooth_all = masked_gaussian_smooth(height_final, roi,
                                                cfg.unreliable_smooth_sigma_px, consts)
            height_final = torch.where(roi & ~output_reliable, smooth_all, height_final)

        # --- frontier outside band -> base
        if cfg.frontier_zero_enable and band > 0:
            dist_out = dist_fn(~output_reliable, max_dist=band + 4)
            outside_band = roi & ~output_reliable & (
                torch.clamp(dist_out - 1.0, min=0.0) <= float(band))
            height_final = torch.where(outside_band, base, height_final)

        # --- clamp positives
        if not cfg.allow_positive_deformation:
            clamp_sel = roi & torch.isfinite(height_final)
            height_final = torch.where(clamp_sel, torch.clamp(height_final, max=0.0),
                                       height_final)
        if self.stop_after == "assemble":
            return {"x": height_final}

        # --- mm conversion
        height_out = height_final
        if cfg.output_height_in_mm:
            depth_mm = scalar_models.height_unitless_to_depth_mm(
                height_final, self.p2h_model, self.use_neg)
            height_out = -depth_mm if cfg.mm_keep_indentation_negative else depth_mm

        # --- contact blob filter
        contact_kept = torch.zeros_like(roi)
        if cfg.filter_small_contact_blobs and cfg.output_height_in_mm:
            roi_f = roi & torch.isfinite(height_out)
            depth = -height_out if cfg.mm_keep_indentation_negative else height_out
            cand = roi_f & (depth > cfg.contact_blob_cand_eps_mm)
            gmax = masked_max(depth, cand)
            thr = torch.clamp(cfg.contact_blob_min_peak_rel_frac * gmax,
                              min=cfg.contact_blob_min_peak_mm)
            kept = filter_components_by_peak(cand, depth, thr,
                                             min_area_px=cfg.contact_blob_min_area_px)
            height_out = torch.where(cand & ~kept, 0.0, height_out)
            contact_kept = kept

        # --- estimated grating period
        period_ref = wf / torch.clamp(torch.abs(dref.k[0]), min=1e-9)
        period_def = wf / torch.clamp(torch.abs(ddef.k[0]), min=1e-9)

        out = {
            "height_map_mm_crop": height_out.to(torch.float32),
            "height_map_unitless_crop": height_final.to(torch.float32),
            "output_reliable_crop": output_reliable,
            "reliable_crop": reliable,
            "contact_dilated_crop": contact_d,
            "contact_kept_crop": contact_kept,
            "est_period_px": 0.5 * (period_ref + period_def),
            "carrier_k_ref": dref.k,
            "carrier_k_def": ddef.k,
            "phase_wrapped_crop": phase_wrapped,
        }
        if self.debug_outputs:
            out.update({
                "dbg_def_gray_aligned": def_gray,
                "dbg_ref_gray": ref_gray,
                "dbg_quality": quality,
                "dbg_amp_ref": dref.amp,
                "dbg_amp_def": ddef.amp,
                "dbg_unwrapped": phase_unwrapped,
                "dbg_phase_zeroed": phase_zeroed,
                "dbg_ecc_warp": ecc_warp,
                "dbg_ecc_rho": ecc_rho,
                "dbg_ecc_iters": ecc_it,
                "dbg_global_shift": torch.stack([gs_dx, gs_dy]),
                "dbg_phase_ref": torch.angle(dref.complex_demod).to(torch.float32),
                "dbg_phase_def": torch.angle(ddef.complex_demod).to(torch.float32),
                "dbg_i_norm_ref": dref.i_norm,
                "dbg_i_norm_def": ddef.i_norm,
                "dbg_peak_ref": dref.peak_f,
            })
        return out
