"""Force sensing: frame pair -> FTP mm heightmap -> volume -> Newtons
(JAX ``pipelines/force.py``).

Besides ``ForcePipeline.__call__`` (host dict of maps and scalars), the
pipeline offers the JAX package's device surfaces: BASELINE config 2's
per-taxel contact classification, config 3's normal-force map, and the
evidence harness's scalar-only reductions.  Each is a callable from device
frame tensors to device tensors; none copies a map to the host.
"""
from __future__ import annotations

import os
from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from plainref.calib import artifacts, scalar_models
from plainref.config import (HEIGHT_TO_FORCE_JSON, PHASE_TO_HEIGHT_JSON, ForceConfig,
                                 FTPConfig)
from plainref.ftp.pipeline import FTPPipeline
from plainref.ops.streams import each


def depth_map_reductions(height_map_mm: torch.Tensor, roi_mask: torch.Tensor,
                         depth_eps_mm: float = 0.01, streams: bool = False):
    """(depth_sum_mm, contact_px, max_depth_mm, any_contact) of the
    indentation side (whichever of +Z / -Z integrates larger in the ROI);
    each (...,) for a (..., H, W) stack of maps, side by side.  With
    ``streams`` (the maps' leading axis a batched forward's stream axis)
    the float sums run once a stream (``ops/streams.py``)."""
    Z = height_map_mm.to(torch.float32)
    Zf = torch.where(torch.isfinite(Z), Z, 0.0)
    pos = torch.clamp(Zf, min=0.0)
    neg = torch.clamp(-Zf, min=0.0)
    pos_sum, neg_sum = each(lambda p, q: (p.sum(dim=(-2, -1), keepdim=True),
                                         q.sum(dim=(-2, -1), keepdim=True)),
                            torch.where(roi_mask, pos, 0.0), torch.where(roi_mask, neg, 0.0),
                            streams=streams)
    depth = torch.where(roi_mask, torch.where(neg_sum > pos_sum, neg, pos), 0.0)
    contact = depth > depth_eps_mm
    depth_sum = each(lambda d: d.sum(dim=(-2, -1)), torch.where(contact, depth, 0.0),
                     streams=streams)
    contact_px = contact.sum(dim=(-2, -1)).to(torch.float32)
    max_depth = torch.where(contact, depth, 0.0).amax(dim=(-2, -1))
    return depth_sum, contact_px, max_depth, contact.flatten(-2).any(dim=-1)


def _px_area(mm_per_px: Union[float, torch.Tensor]):
    """mm_per_px squared in float32: a Python float, or a 0-d device tensor
    where the scale was computed on the device."""
    if isinstance(mm_per_px, torch.Tensor):
        return mm_per_px.to(torch.float32) ** 2
    return float(np.float32(mm_per_px) ** 2)


def depth_map_to_volume_cm3(height_map_mm: torch.Tensor, roi_mask: torch.Tensor,
                            mm_per_px: Union[float, torch.Tensor],
                            depth_eps_mm: float = 0.01, streams: bool = False):
    """(volume_cm3, contact_area_mm2, max_depth_mm): V = sum(depth * px
    area) over depth > eps within the ROI, as 0-d float32 tensors (each
    (...,) for a (..., H, W) stack).  ``mm_per_px`` is a Python float or a
    float32 tensor, 0-d or one a map; ``streams`` as in
    ``depth_map_reductions``."""
    depth_sum, contact_px, max_depth, any_contact = depth_map_reductions(
        height_map_mm, roi_mask, depth_eps_mm, streams=streams)
    px_area = _px_area(mm_per_px)
    volume_cm3 = torch.where(any_contact, depth_sum * px_area / 1000.0, 0.0)
    area_mm2 = torch.where(any_contact, contact_px * px_area, 0.0)
    return volume_cm3, area_mm2, torch.where(any_contact, max_depth, 0.0)


def host_volume_from_reductions(depth_sum, contact_px, max_depth, mm_per_px):
    """The tail of ``depth_map_to_volume_cm3`` on the host over fetched
    reduction scalars, in numpy float32 op for op (f32 square, f32
    products, f32 / 1000).  Returns (volume_cm3, contact_area_mm2,
    max_depth_mm) as Python floats."""
    px_area = np.float32(mm_per_px) ** 2
    volume_mm3 = np.float32(depth_sum) * px_area
    area_mm2 = np.float32(contact_px) * px_area
    if not (np.float32(contact_px) > 0):
        return 0.0, 0.0, 0.0
    return (float(volume_mm3 / np.float32(1000.0)), float(area_mm2),
            float(np.float32(max_depth)))


def _finite_depth(height: torch.Tensor):
    """(Zf, depth, roi) of the surfaces: the finite height over
    roi = isfinite(height), zero elsewhere, and its indentation side."""
    roi = torch.isfinite(height)
    Zf = torch.where(roi, height, 0.0)
    pos = torch.clamp(Zf, min=0.0)
    neg = torch.clamp(-Zf, min=0.0)
    return Zf, torch.where(neg.sum() > pos.sum(), neg, pos), roi


def contact_classification(height: torch.Tensor, mm_per_px: torch.Tensor,
                           depth_eps_mm: float):
    """BASELINE config 2's tail on a crop's mm heightmap: (contact_mask,
    contact_area_mm2, depth_mm), contact = depth > eps."""
    _, depth, _ = _finite_depth(height)
    contact = depth > depth_eps_mm
    area = contact.to(torch.float32).sum() * _px_area(mm_per_px)
    return contact, area, depth


def force_map(height: torch.Tensor, mm_per_px: torch.Tensor, depth_eps_mm: float,
              force_model: Dict[str, Any]):
    """BASELINE config 3's tail on a crop's mm heightmap: (force_map_N,
    displacement_mm, force_N).  The calibrated model is a scalar
    volume -> force law, so the map spreads the total over the contact
    patch in proportion to each taxel's indentation volume and sums to it."""
    Zf, depth, roi = _finite_depth(height)
    v, _, _ = depth_map_to_volume_cm3(height, roi, mm_per_px, depth_eps_mm)
    force_n = scalar_models.predict_force_from_volume(force_model, v, xp=torch)
    depth = torch.where(depth > depth_eps_mm, depth, 0.0)
    vol_px = depth * _px_area(mm_per_px) / 1000.0          # cm^3 per px
    total = torch.clamp(vol_px.sum(), min=1e-12)
    return force_n * vol_px / total, Zf, force_n


class ForcePipeline:
    """frame pair -> {maps..., volume_cm3, contact_area_mm2, max_depth_mm,
    force_N, mm_per_px} on one device, the card unless ``device`` names
    another ("cpu" runs the kernels' plain versions).  Frames are numpy
    arrays or tensors; a tensor on the pipeline's device is not copied."""

    def __init__(self, ftp_cfg: FTPConfig, force_cfg: ForceConfig,
                 p2h_model: Dict[str, Any], force_model: Dict[str, Any],
                 use_negated_height: bool = True, debug_outputs: bool = False, *,
                 device="cuda"):
        self.ftp = FTPPipeline(ftp_cfg, p2h_model, use_negated_height,
                               debug_outputs=debug_outputs, device=device)
        self.force_cfg = force_cfg
        self.force_model = force_model

    @classmethod
    def from_artifacts(cls, data_root: str, ftp_cfg: Optional[FTPConfig] = None,
                       force_cfg: Optional[ForceConfig] = None,
                       debug_outputs: bool = False, *, device="cuda") -> "ForcePipeline":
        """The pipeline over the reference layout's phase-to-height and
        height-to-force calibrations under ``data_root``, under ``ftp_cfg``
        (default ``FTPConfig()``, the parity preset) and ``force_cfg``."""
        p2h, use_neg = artifacts.load_phase_to_height(
            os.path.join(data_root, PHASE_TO_HEIGHT_JSON))
        fc = artifacts.load_force_calibration(os.path.join(data_root, HEIGHT_TO_FORCE_JSON))
        return cls(ftp_cfg or FTPConfig(), force_cfg or ForceConfig(), p2h, fc["best_model"],
                   use_neg, debug_outputs=debug_outputs, device=device)

    def mm_per_px(self, est_period_px: float) -> float:
        """Grating pitch / FFT-estimated period."""
        if self.force_cfg.override_mm_per_px is not None:
            return float(self.force_cfg.override_mm_per_px)
        if est_period_px is None or not np.isfinite(est_period_px) or est_period_px <= 1e-12:
            raise RuntimeError(f"Invalid estimated_grating_period_px={est_period_px}")
        return float(self.force_cfg.grating_pitch_mm) / float(est_period_px)

    def mm_per_px_device(self, est_period_px: torch.Tensor) -> torch.Tensor:
        """``mm_per_px`` as a 0-d float32 tensor on the period's device,
        with no host copy: the override, else pitch / max(period, 1e-12)."""
        cfg = self.force_cfg
        if cfg.override_mm_per_px is not None:
            return torch.full((), float(cfg.override_mm_per_px), dtype=torch.float32,
                              device=est_period_px.device)
        return cfg.grating_pitch_mm / torch.clamp(est_period_px, min=1e-12)

    def _forward(self, ref_bgr, def_bgr) -> Dict[str, torch.Tensor]:
        ftp = self.ftp
        return ftp.forward(ftp.upload(ref_bgr), ftp.upload(def_bgr))

    def __call__(self, ref_bgr, def_bgr, roi_from_finite: bool = False) -> Dict[str, Any]:
        """Run FTP + volume + force over the eroded-circle ROI, or with
        ``roi_from_finite`` over the finite cells of the heightmap (the
        multimodal orchestrator's convention), taken on the device."""
        out = self._forward(ref_bgr, def_bgr)
        height = out["height_map_mm_crop"]
        roi = torch.isfinite(height) if roi_from_finite else self.ftp.roi
        mm_per_px = self.mm_per_px(float(out["est_period_px"]))
        v, a, d = depth_map_to_volume_cm3(height, roi, mm_per_px, self.force_cfg.depth_eps_mm)
        res = self.ftp.to_host(out)
        v, a, d = (float(t) for t in torch.stack([v, a, d]).cpu())
        force_n = scalar_models.predict_force_from_volume(self.force_model, v, xp=np)
        res.update({
            "volume_cm3": v,
            "contact_area_mm2": a,
            "max_depth_mm": d,
            "force_N": float(force_n),
            "mm_per_px": mm_per_px,
        })
        return res

    # ------------------------------------------------------------------
    # BASELINE configs 2/3 and the evidence harness: device surfaces
    # ------------------------------------------------------------------
    def contact_classification_device(self):
        """BASELINE config 2: frame pair -> (contact_mask (crop_h, crop_w),
        contact_area_mm2, depth_mm), all on the device.  The FTP
        registration and normalisation stages are the preprocessing chain;
        depth > eps is the per-taxel contact classifier."""
        eps = self.force_cfg.depth_eps_mm

        def fn(ref_bgr, def_bgr):
            out = self._forward(ref_bgr, def_bgr)
            return contact_classification(out["height_map_mm_crop"],
                                          self.mm_per_px_device(out["est_period_px"]), eps)
        return fn

    def force_map_device(self):
        """BASELINE config 3: frame pair -> (force_map_N (crop_h, crop_w),
        displacement_mm, force_N), all on the device (see ``force_map``).
        Normal force only: the reference has no shear model."""
        eps = self.force_cfg.depth_eps_mm

        def fn(ref_bgr, def_bgr):
            out = self._forward(ref_bgr, def_bgr)
            return force_map(out["height_map_mm_crop"],
                             self.mm_per_px_device(out["est_period_px"]), eps,
                             self.force_model)
        return fn

    def evidence_reductions_device(self, roi_from_finite: bool = False):
        """Frame pair -> a (4,) float32 device tensor: the volume
        integrator's depth sum, contact pixels and max depth, and the
        estimated grating period, for ``evidence_scalars``."""
        eps = self.force_cfg.depth_eps_mm

        def fn(ref_bgr, def_bgr):
            out = self._forward(ref_bgr, def_bgr)
            height = out["height_map_mm_crop"]
            roi = torch.isfinite(height) if roi_from_finite else self.ftp.roi
            s, n, d, _ = depth_map_reductions(height, roi, eps)
            return torch.stack([s, n, d, out["est_period_px"]])
        return fn

    def evidence_scalars(self, ref_bgr, def_bgr, fn) -> Dict[str, float]:
        """The scalar fields of ``__call__`` (volume, area, max depth,
        force, mm_per_px, period) from ``evidence_reductions_device``'s
        four scalars, fetched in one device-to-host copy."""
        s, n, d, period = fn(ref_bgr, def_bgr).cpu().tolist()
        mm = self.mm_per_px(period)
        v, a, dmax = host_volume_from_reductions(s, n, d, np.float32(mm))
        force_n = scalar_models.predict_force_from_volume(self.force_model, v, xp=np)
        return {"volume_cm3": v, "contact_area_mm2": a, "max_depth_mm": dmax,
                "force_N": float(force_n), "mm_per_px": mm,
                "estimated_grating_period_px": period}
