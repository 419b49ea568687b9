"""Temperature inference: BGR frame -> fused per-pixel degC map and stats
(JAX ``temperature/inference.py``).

Stages in order: gray, stripe segmentation on the full frame
(``segmentation.py``; its median is K1 under 'hist_pallas'), then, on the
static compute bbox around the outer ROI where ``crop_compute`` sets one
and on the full frame otherwise: the 5x5 feature blur per channel, the
colour-support gate, the per-pixel models (fused in K8, or the unfused LAB
and ``TempModelWeights.predict``), the per-domain inpaints (K3), clamping,
the per-pixel fusion, the stripe-oriented smoothing (by the three-shear
rotation or by bilinear gathers), the ROI statistics, and the re-embed into
the frame.

On the card the forward is one CUDA graph for each value of
``stats_only``, replayed at every frame (``TemperaturePipeline.forward``),
as the JAX package jits ``_forward`` and ``_stats_forward``; the shear
fold's ``lax.cond`` is an IF node of it.  On the CPU it runs op by op
(``forward_eager``).

It runs every ``TempConfig``: the deploy preset (``TempConfig().deploy()``)
and the parity preset (``TempConfig()``, the CLI's default), their scaled
versions, and each knob on its own, on the route the JAX package takes on
a TPU.  Off the TPU the JAX package runs the unfused path even where
``use_fused_kernel`` is set; the port runs K8 wherever it is set.
"""
from __future__ import annotations

import functools
import math
from typing import Any, Dict, Optional

import numpy as np
import torch

from vistaf_torch import use_full_fp32
from vistaf_torch.calib.temp_weights import TempModelWeights, load_reference_models
from vistaf_torch.config import TempConfig
from vistaf_torch.kernels.temp_kernel import make_fused_temperature_fn
from vistaf_torch.ops import geometry
from vistaf_torch.ops.color import bgr_to_gray, bgr_to_lab_u8, chroma_ab
from vistaf_torch.ops.consts import DeviceConsts
from vistaf_torch.ops.filters import (gaussian_blur, gaussian_blur_constants,
                                      gaussian_blur_u8_round)
from vistaf_torch.ops.inpaint import inpaint_within_roi
from vistaf_torch.ops.morphology import dilate, ellipse_kernel
from vistaf_torch.ops.warp import (invert_affine, rotate_stack_shear, rotation_matrix,
                                   sample_bilinear_stack)
from vistaf_torch.temperature.segmentation import segment_stripes
from vistaf_torch.utils.cuda_graph import ForwardGraph, device_if

STATS = ("t_mean", "t_min", "t_max", "t_std", "valid_pixels", "stripe_angle_rad",
         "stripe_period_px")


def clamp_map(m: torch.Tensor, roi: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """Clip the finite ROI values to [lo, hi]; NaN outside the ROI."""
    out = torch.where(roi & torch.isfinite(m), torch.clamp(m, lo, hi), m)
    return torch.where(roi, out, math.nan)


def fuse_maps_per_pixel(roi, wide_map, color_map, cfg: TempConfig):
    """WIDE baseline, COLOR inside its validity band, a linear blend near the
    top of the COLOR range, final clamp: (final, source, color_ok), source
    0 (WIDE), 255 (COLOR) or 128 (blend)."""
    wide_ok = roi & torch.isfinite(wide_map)
    color_ok = (roi & torch.isfinite(color_map)
                & (color_map >= cfg.color_t_min - cfg.color_guard_band)
                & (color_map <= cfg.color_t_max + cfg.color_guard_band))
    final = torch.where(color_ok, color_map, wide_map)
    source = color_ok.to(torch.uint8) * 255

    low_th = cfg.color_t_max - cfg.switch_margin_c
    high_th = cfg.color_t_max + cfg.switch_margin_c
    blend = wide_ok & color_ok & (wide_map > low_th) & (wide_map < high_th)
    wgt = torch.clamp((high_th - wide_map) / (high_th - low_th), 0.0, 1.0)
    final = torch.where(blend, wgt * color_map + (1.0 - wgt) * wide_map, final)
    source = torch.where(blend, torch.full_like(source, 128), source)
    final = clamp_map(final, roi, cfg.final_t_min, cfg.final_t_max)
    return final.to(torch.float32), source, color_ok


def _rotate_stack(stack: torch.Tensor, M: torch.Tensor, consts: DeviceConsts) -> torch.Tensor:
    """Forward-warp the channel-first (C, H, W) stack by the affine ``M``:
    every output pixel bilinearly samples the stack at M^-1 of its position,
    zeros outside (one index computation for all channels)."""
    _, h, w = stack.shape
    Minv = invert_affine(M)
    yy, xx = consts.iota(h, w, 0), consts.iota(h, w, 1)
    sx = Minv[0, 0] * xx + Minv[0, 1] * yy + Minv[0, 2]
    sy = Minv[1, 0] * xx + Minv[1, 1] * yy + Minv[1, 2]
    return sample_bilinear_stack(stack, sy, sx)


def oriented_gaussian_blur(map_f: torch.Tensor, roi: torch.Tensor, angle_rad: torch.Tensor,
                           sigma_across: float, sigma_along: float,
                           consts: DeviceConsts, method: str = "gather",
                           vpu: bool = False) -> torch.Tensor:
    """Rotate so the across-stripe direction lies along +x, blur with
    (sigma_across, sigma_along), rotate back; NaN where the rotated ROI does
    not return.  ``method`` 'gather' (the parity preset's) rotates the map
    and its ROI by bilinear gathers (``_rotate_stack``) about the frame's
    centre, and back by the opposite angle.  'shear' (the deploy preset's)
    rotates by three shears: angles are folded by quarter turns into the
    shear's range, and an odd quarter turn swaps the two sigmas: the JAX
    ``lax.cond`` on the fold's parity, here two ``device_if`` that write
    one output (IF nodes in a captured forward), so one blur runs."""
    if sigma_across <= 0 and sigma_along <= 0:
        return torch.where(roi, map_f, math.nan)
    h, w = map_f.shape
    center = (w / 2.0, h / 2.0)
    angle_deg = -angle_rad * 180.0 / math.pi
    sa = float(max(sigma_across, 1e-6))
    sl = float(max(sigma_along, 1e-6))

    map0 = torch.where(torch.isfinite(map_f), map_f, 0.0)
    stack0 = torch.stack([map0, roi.to(torch.float32)])
    if method == "shear":
        q = torch.round(angle_deg / 90.0)
        ang = angle_deg - 90.0 * q
        odd = torch.remainder(torch.abs(q.to(torch.int32)), 2) == 1
        rot = rotate_stack_shear(stack0, ang, center)
        blurred = torch.empty_like(rot[0])
        for pred, sx, sy in ((odd, sl, sa), (~odd, sa, sl)):
            # the branch's band matrices are built here, outside its body:
            # a capture cannot copy them from the host
            gaussian_blur_constants(rot.shape[1:], sx, consts, sigma_y=sy, vpu=vpu)
            device_if(pred, lambda out, sx=sx, sy=sy: out.copy_(
                gaussian_blur(rot[0], sx, consts, sigma_y=sy, vpu=vpu)), blurred, site="fold")
        stack1 = torch.stack([blurred, (rot[1] > 0.5).to(torch.float32)])
        back = rotate_stack_shear(stack1, -ang, center)
        return torch.where(back[1] > 0.5, back[0], math.nan)

    rot = _rotate_stack(stack0, rotation_matrix(center, angle_deg), consts)
    blurred = gaussian_blur(rot[0], sa, consts, sigma_y=sl, vpu=vpu)
    stack1 = torch.stack([blurred, (rot[1] > 0.5).to(torch.float32)])
    back = _rotate_stack(stack1, rotation_matrix(center, -angle_deg), consts)
    return torch.where(back[1] > 0.5, back[0], math.nan)


class TemperaturePipeline:
    """BGR frame -> temperature maps and stats on one device::

        pipe = TemperaturePipeline(TempConfig().deploy(), color, wide)
        out = pipe(frame_bgr_u8)      # dict of numpy arrays and scalars
        st = pipe.stats(frame_bgr_u8)  # the scalar statistics only

    ``device`` defaults to the card, where ``forward`` replays a CUDA
    graph; pass ``device="cpu"`` for the plain versions of the kernels,
    op by op.  The pipeline owns its static geometry (ROI
    masks, the compute bbox), the blur and twiddle matrices and the packed
    model tables on its device, built once.  ``from_artifacts`` loads the
    newest reference model bundles under a data root."""

    def __init__(self, cfg: TempConfig, color_model: TempModelWeights,
                 wide_model: TempModelWeights, *, device="cuda"):
        self.check_config(cfg)
        self.cfg = cfg
        self.color_model = color_model
        self.wide_model = wide_model
        self.device = torch.device(device)
        if self.device.type == "cuda":
            use_full_fp32()
        self.consts = DeviceConsts(self.device)

        h, w = cfg.image_height, cfg.image_width
        outer = geometry.circle_from_3_points_exact(
            cfg.outer_circle_p1, cfg.outer_circle_p2, cfg.outer_circle_p3)
        self._roi_outer = geometry.circular_mask(h, w, *outer)
        if cfg.use_inner_circle:
            inner = geometry.circle_from_3_points_exact(
                cfg.inner_circle_p1, cfg.inner_circle_p2, cfg.inner_circle_p3)
            self._roi_full = geometry.annulus_mask(h, w, inner, outer)
        else:
            self._roi_full = self._roi_outer
        self._crop_bbox = (geometry.bbox_from_mask(self._roi_outer, pad=cfg.crop_pad_px)
                           if cfg.crop_output_to_outer_roi else None)
        self._compute_bbox = self.compute_bbox(cfg)
        self.roi_full = torch.as_tensor(self._roi_full, device=self.device)
        self.roi_outer = torch.as_tensor(self._roi_outer, device=self.device)
        self._fused_fn = (make_fused_temperature_fn(cfg.color_chroma_min, color_model,
                                                    wide_model)
                          if cfg.use_fused_kernel else None)
        self._graphs: Dict[bool, ForwardGraph] = {}

    @classmethod
    def from_artifacts(cls, data_root: str, cfg: Optional[TempConfig] = None, *,
                       device="cuda") -> "TemperaturePipeline":
        """The pipeline over the newest COLOR and WIDE bundles of the
        reference layout under ``data_root`` (``load_reference_models``),
        under ``cfg`` (default ``TempConfig()``, the parity preset)."""
        color, wide = load_reference_models(data_root)
        return cls(cfg or TempConfig(), color, wide, device=device)

    @staticmethod
    def compute_bbox(cfg: TempConfig):
        """The static (y0, y1, x0, x1) crop the per-pixel stages run on
        (``crop_compute``), as the JAX pipeline builds it: the outer-ROI
        bbox padded by the reach of every local op (the inpaint iterations,
        and the first shear pass's overshoot of up to 0.1 * (R + 128)),
        edges aligned to 8 rows and 128 columns; None without
        ``crop_compute``."""
        if not cfg.crop_compute:
            return None
        h, w = cfg.image_height, cfg.image_width
        outer = geometry.circle_from_3_points_exact(
            cfg.outer_circle_p1, cfg.outer_circle_p2, cfg.outer_circle_p3)
        pad = max(64, cfg.wide_inpaint_iters + 8, cfg.color_inpaint_iters + 8,
                  int(0.1 * (float(outer[2]) + 128.0)) + 8)
        y0, y1, x0, x1 = geometry.bbox_from_mask(geometry.circular_mask(h, w, *outer),
                                                 pad=pad)
        return (max(0, (y0 // 8) * 8), min(h, -(-y1 // 8) * 8),
                max(0, (x0 // 128) * 128), min(w, -(-x1 // 128) * 128))

    @staticmethod
    def check_config(cfg: TempConfig) -> None:
        """Every value of every ``TempConfig`` knob is ported, so nothing the
        JAX package runs is rejected; a route knob holding a value the JAX
        package does not know raises ValueError (the JAX package would take
        its last branch for it, or fail at its first frame)."""
        known = {"rotate_method": ("gather", "shear"), "seg_peak_method": ("topk", "cascade"),
                 "seg_bandpass": ("fft", "matmul"), "seg_fft": ("fft2", "rfft2"),
                 "percentile_method": ("sort", "hist", "hist_pallas")}
        for knob, values in known.items():
            if getattr(cfg, knob) not in values:
                raise ValueError(f"{knob}={getattr(cfg, knob)!r} is none of {values}")

    # ------------------------------------------------------------------
    def upload(self, frame) -> torch.Tensor:
        """The frame on the pipeline's device: a numpy array is copied
        there, a tensor already there passes through untouched."""
        if isinstance(frame, torch.Tensor):
            return frame.to(self.device)
        return torch.as_tensor(np.ascontiguousarray(frame), device=self.device)

    def __call__(self, frame_bgr) -> Dict[str, Any]:
        return self.to_host(self.forward(self.upload(frame_bgr)))

    def to_host(self, out: Dict[str, torch.Tensor]) -> Dict[str, Any]:
        """``forward``'s maps and stats as numpy, with the static ROI masks
        and the output crop's bbox."""
        res = {k: v.cpu().numpy() for k, v in out.items()}
        res["roi_full"] = self._roi_full
        res["roi_outer"] = self._roi_outer
        res["crop_bbox"] = self._crop_bbox
        return res

    def stats(self, frame_bgr) -> Dict[str, np.ndarray]:
        """The scalar statistics of ``__call__`` only (one device-to-host
        copy): t_mean/min/max/std, valid_pixels, stripe angle and period."""
        out = self.forward(self.upload(frame_bgr), stats_only=True)
        vals = torch.stack([out[k].to(torch.float64) for k in STATS]).cpu().numpy()
        res = {k: np.float32(v) for k, v in zip(STATS, vals)}
        res["valid_pixels"] = np.int32(vals[STATS.index("valid_pixels")])
        return res

    # ------------------------------------------------------------------
    def graph_route(self) -> bool:
        """Whether ``forward`` replays a CUDA graph: on the card, under every
        configuration (the fold's ``lax.cond`` is an IF node, and nothing
        else in the forward reads the device on the host)."""
        return self.device.type == "cuda"

    def forward(self, frame_bgr: torch.Tensor, stats_only: bool = False
                ) -> Dict[str, torch.Tensor]:
        """The forward on a device tensor (a BGR uint8 frame).  Where
        ``graph_route`` holds, one CUDA graph of ``forward_eager`` for each
        value of ``stats_only`` (the JAX package's ``_forward`` and
        ``_stats_forward``), captured at its first call and replayed at
        every later one (``ForwardGraph``: a frame of another shape
        raises); elsewhere ``forward_eager``."""
        if self.graph_route():
            graph = self._graphs.get(stats_only)
            if graph is None:
                graph = self._graphs[stats_only] = ForwardGraph(
                    functools.partial(self.forward_eager, stats_only=stats_only), self.device)
            return graph(frame_bgr)
        return self.forward_eager(frame_bgr, stats_only)

    def forward_eager(self, frame_bgr: torch.Tensor, stats_only: bool = False
                      ) -> Dict[str, torch.Tensor]:
        """The forward op by op: what the CUDA graphs capture, and the CPU's
        route.  ``stats_only`` returns the statistics alone."""
        cfg, consts = self.cfg, self.consts
        roi_full, roi_outer = self.roi_full, self.roi_outer
        full_hw = tuple(frame_bgr.shape[:2])

        seg = segment_stripes(bgr_to_gray(frame_bgr), roi_full, cfg, consts,
                              compute_bbox=self._compute_bbox)

        cb = self._compute_bbox

        def crop(a):
            return a[cb[0]:cb[1], cb[2]:cb[3]] if cb is not None else a

        def embed(a, fill):
            if cb is None:
                return a
            full = torch.full(full_hw + tuple(a.shape[2:]), fill, dtype=a.dtype,
                              device=a.device)
            full[cb[0]:cb[1], cb[2]:cb[3]] = a
            return full

        frame_c = crop(frame_bgr)
        roi_full_c = crop(roi_full)
        roi_eff_c = crop(seg.roi_eff)

        if cfg.blur_ksize > 1:
            blurred = torch.stack(
                [gaussian_blur_u8_round(frame_c[..., i].to(torch.float32), cfg.blur_ksize,
                                        consts, vpu=cfg.conv_vpu) for i in range(3)],
                dim=-1)
        else:
            blurred = frame_c.to(torch.float32)

        k = cfg.color_support_dilate | 1
        csup_pre = dilate(crop(seg.light), ellipse_kernel(k, k)) & roi_eff_c & ~crop(seg.sat)
        chroma = None
        if self._fused_fn is not None:
            wide_map_raw, color_map_raw, color_support = self._fused_fn(
                blurred.contiguous(), roi_eff_c, csup_pre)
        else:
            lab = bgr_to_lab_u8(blurred)
            L, a, b = lab[..., 0], lab[..., 1], lab[..., 2]
            chroma = chroma_ab(a, b)
            color_support = csup_pre & (chroma >= cfg.color_chroma_min)
            wide_pred = self.wide_model.predict(
                torch.stack([L, a, b, bgr_to_gray(blurred)], dim=-1))
            wide_map_raw = torch.where(roi_eff_c, wide_pred, math.nan)
            color_pred = self.color_model.predict(torch.stack([L, a, b], dim=-1))
            color_map_raw = torch.where(color_support, color_pred, math.nan)

        wide_map = inpaint_within_roi(wide_map_raw, roi_full_c,
                                      ~torch.isfinite(wide_map_raw) & roi_full_c,
                                      iters=cfg.wide_inpaint_iters, quantize_u8=True)
        wide_map = clamp_map(wide_map, roi_full_c, cfg.final_t_min, cfg.final_t_max)
        color_map = inpaint_within_roi(color_map_raw, color_support,
                                       ~torch.isfinite(color_map_raw) & color_support,
                                       iters=cfg.color_inpaint_iters, quantize_u8=True)
        color_map = clamp_map(color_map, color_support,
                              cfg.color_t_min - 5.0, cfg.color_t_max + 5.0)

        final_fused, source_map, color_ok = fuse_maps_per_pixel(
            roi_full_c, wide_map, color_map, cfg)
        if cfg.final_smooth_enable:
            final_map = oriented_gaussian_blur(final_fused, roi_full_c, seg.angle_rad,
                                               cfg.final_smooth_sigma_across,
                                               cfg.final_smooth_sigma_along, consts,
                                               method=cfg.rotate_method, vpu=cfg.conv_vpu)
            final_map = clamp_map(final_map, roi_full_c, cfg.final_t_min, cfg.final_t_max)
        else:
            final_map = final_fused

        stats_roi = crop(roi_outer if cfg.crop_output_to_outer_roi else roi_full)
        inside = stats_roi & torch.isfinite(final_map)
        n = torch.clamp(inside.to(torch.float32).sum(), min=1.0)
        t_mean = torch.where(inside, final_map, 0.0).sum() / n
        stats = {
            "t_mean": t_mean,
            "t_min": torch.where(inside, final_map, math.inf).amin(),
            "t_max": torch.where(inside, final_map, -math.inf).amax(),
            "t_std": torch.sqrt(torch.where(inside, (final_map - t_mean) ** 2, 0.0).sum() / n),
            "valid_pixels": inside.to(torch.int32).sum(dtype=torch.int32),
            "stripe_angle_rad": seg.angle_rad,
            "stripe_period_px": seg.period_px,
        }
        if stats_only:
            return stats
        return {
            "temperature_map_fused": embed(final_fused, math.nan),
            "temperature_map_final": embed(final_map, math.nan),
            "wide_map": embed(wide_map, math.nan),
            "color_map": embed(color_map, math.nan),
            "wide_map_raw": embed(wide_map_raw, math.nan),
            "color_map_raw": embed(color_map_raw, math.nan),
            "source_map": embed(source_map, 0),
            **({"chroma": embed(chroma, 0.0)} if chroma is not None else {}),
            "mask_dark": seg.dark,
            "mask_light": seg.light,
            "mask_sat": seg.sat,
            "mask_roi_eff": seg.roi_eff,
            "mask_color_support": embed(color_support, False),
            "mask_color_ok": embed(color_ok, False),
            "seg_peak_xy": seg.peak_xy,
            **stats,
        }
