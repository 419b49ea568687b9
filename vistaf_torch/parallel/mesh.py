"""The force forward over a batch of camera streams (JAX
``parallel/mesh.py::BatchedForce``).

The JAX package vmaps the forward, its Pallas kernels included.  The port's
forward ends its data-dependent loops on host checks, one frame at a time,
so the batch is a loop over the streams on the pipeline's device: each
stream's result is bit for bit the single forward's.  Kernels with a batch
grid and per-stream done flags are ROADMAP work; so are ``sharded``,
``make_stream_mesh``, ``shard_batch``, ``whole_limb_step*`` and
``motion_gate`` (Queue 1 item 7).
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from vistaf_torch.calib import scalar_models
from vistaf_torch.ftp.pipeline import FTPPipeline
from vistaf_torch.pipelines.force import depth_map_to_volume_cm3


class BatchedForce:
    """(B, H, W, 3) uint8 ref/def stacks -> per-stream force scalars and
    heightmaps, on the device of ``pipe``.

    Keeps the JAX defaults: a 2 mm grating pitch, a 0.01 mm contact
    threshold, and a 1e-9 floor on the period (``ForcePipeline`` uses
    1e-12)."""

    def __init__(self, pipe: FTPPipeline, force_model: Dict[str, Any],
                 grating_pitch_mm: float = 2.0, depth_eps_mm: float = 0.01):
        self.pipe = pipe
        self.force_model = force_model
        self.grating_pitch_mm = grating_pitch_mm
        self.depth_eps_mm = depth_eps_mm
        self.device = pipe.device

    def _single(self, ref_bgr, def_bgr) -> Dict[str, torch.Tensor]:
        """One stream's forward and volume -> force tail, on the device."""
        pipe = self.pipe
        res = pipe.forward(pipe.upload(ref_bgr), pipe.upload(def_bgr))
        height = res["height_map_mm_crop"]
        mm_per_px = self.grating_pitch_mm / torch.clamp(res["est_period_px"], min=1e-9)
        v, a, d = depth_map_to_volume_cm3(height, torch.isfinite(height), mm_per_px,
                                          self.depth_eps_mm)
        return {
            "force_N": scalar_models.predict_force_from_volume(self.force_model, v),
            "volume_cm3": v,
            "contact_area_mm2": a,
            "max_depth_mm": d,
            "height_map_mm": height,
        }

    def batched(self):
        """A callable from (B, H, W, 3) uint8 ref and def stacks (numpy or
        device tensors) to a dict of stacked device tensors: (B,) scalars
        and the (B, crop_h, crop_w) heightmaps."""
        def fn(refs, frames):
            refs, frames = self.pipe.upload(refs), self.pipe.upload(frames)
            if refs.dim() != 4 or refs.shape != frames.shape:
                raise ValueError(f"expected two (B, H, W, 3) stacks, got "
                                 f"{tuple(refs.shape)} and {tuple(frames.shape)}")
            outs = [self._single(refs[b], frames[b]) for b in range(frames.shape[0])]
            return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}
        return fn
