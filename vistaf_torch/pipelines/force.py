"""Force sensing: frame pair -> FTP mm heightmap -> volume -> Newtons
(JAX ``pipelines/force.py``)."""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from vistaf_torch.calib import scalar_models
from vistaf_torch.config import ForceConfig, FTPConfig
from vistaf_torch.ftp.pipeline import FTPPipeline


def depth_map_reductions(height_map_mm: torch.Tensor, roi_mask: torch.Tensor,
                         depth_eps_mm: float = 0.01):
    """(depth_sum_mm, contact_px, max_depth_mm, any_contact) of the
    indentation side (whichever of +Z / -Z integrates larger in the ROI)."""
    Z = height_map_mm.to(torch.float32)
    Zf = torch.where(torch.isfinite(Z), Z, 0.0)
    pos = torch.clamp(Zf, min=0.0)
    neg = torch.clamp(-Zf, min=0.0)
    pos_sum = torch.where(roi_mask, pos, 0.0).sum()
    neg_sum = torch.where(roi_mask, neg, 0.0).sum()
    depth = torch.where(roi_mask, torch.where(neg_sum > pos_sum, neg, pos), 0.0)
    contact = depth > depth_eps_mm
    depth_sum = torch.where(contact, depth, 0.0).sum()
    contact_px = contact.sum().to(torch.float32)
    max_depth = torch.where(contact, depth, 0.0).amax()
    return depth_sum, contact_px, max_depth, contact.any()


def depth_map_to_volume_cm3(height_map_mm: torch.Tensor, roi_mask: torch.Tensor,
                            mm_per_px: float, depth_eps_mm: float = 0.01):
    """(volume_cm3, contact_area_mm2, max_depth_mm): V = sum(depth * px
    area) over depth > eps within the ROI, as 0-d float32 tensors."""
    depth_sum, contact_px, max_depth, any_contact = depth_map_reductions(
        height_map_mm, roi_mask, depth_eps_mm)
    px_area = float(np.float32(mm_per_px) ** 2)
    volume_cm3 = torch.where(any_contact, depth_sum * px_area / 1000.0, 0.0)
    area_mm2 = torch.where(any_contact, contact_px * px_area, 0.0)
    return volume_cm3, area_mm2, torch.where(any_contact, max_depth, 0.0)


class ForcePipeline:
    """frame pair -> {maps..., volume_cm3, contact_area_mm2, max_depth_mm,
    force_N, mm_per_px} on one device, the card unless ``device`` names
    another ("cpu" runs the kernels' plain versions)."""

    def __init__(self, ftp_cfg: FTPConfig, force_cfg: ForceConfig,
                 p2h_model: Dict[str, Any], force_model: Dict[str, Any],
                 use_negated_height: bool = True, debug_outputs: bool = False, *,
                 device="cuda"):
        self.ftp = FTPPipeline(ftp_cfg, p2h_model, use_negated_height,
                               debug_outputs=debug_outputs, device=device)
        self.force_cfg = force_cfg
        self.force_model = force_model

    def mm_per_px(self, est_period_px: float) -> float:
        """Grating pitch / FFT-estimated period."""
        if self.force_cfg.override_mm_per_px is not None:
            return float(self.force_cfg.override_mm_per_px)
        if est_period_px is None or not np.isfinite(est_period_px) or est_period_px <= 1e-12:
            raise RuntimeError(f"Invalid estimated_grating_period_px={est_period_px}")
        return float(self.force_cfg.grating_pitch_mm) / float(est_period_px)

    def __call__(self, ref_bgr: np.ndarray, def_bgr: np.ndarray) -> Dict[str, Any]:
        """Run FTP + volume + force over the eroded-circle ROI."""
        ftp = self.ftp
        out = ftp.forward(ftp.upload(ref_bgr), ftp.upload(def_bgr))
        mm_per_px = self.mm_per_px(float(out["est_period_px"]))
        v, a, d = depth_map_to_volume_cm3(out["height_map_mm_crop"], ftp.roi, mm_per_px,
                                          self.force_cfg.depth_eps_mm)
        res = ftp.to_host(out)
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
