"""Multimodal sensing: one frame pair -> force + shape + temperature
(JAX ``pipelines/multimodal.py``).

The force and temperature pipelines are explicit objects on one device that
share the deformed frame.  Two execution shapes:

- ``__call__`` runs the two modality forwards one after the other and
  fetches both full output dicts; the deformed frame is uploaded once
  (``ingest``) and both forwards read that tensor.
- ``step_fused`` uploads each frame once, runs both forwards on the same
  device tensors and reduces volume, area, depth and force on the device,
  so that ``fetch='scalars'`` moves every scalar in one device-to-host copy
  and no map.  On the card the two forwards and the reduction are one CUDA
  graph (``fused_forward``), one for each fetch, as the JAX package jits
  ``_fused_impl`` as one graph; ``__call__`` replays the two pipelines'
  own graphs, as the JAX package makes two jitted calls there.

``from_artifacts`` builds both pipelines from the reference calibration
artifacts under a data root.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Optional

import numpy as np
import torch

from vistaf_torch.calib import scalar_models
from vistaf_torch.config import ForceConfig, FTPConfig, TempConfig
from vistaf_torch.pipelines.force import ForcePipeline, depth_map_to_volume_cm3
from vistaf_torch.temperature.inference import TemperaturePipeline
from vistaf_torch.utils import profiling
from vistaf_torch.utils.cuda_graph import ForwardGraph

TEMP_SCALARS = ("t_mean", "t_min", "t_max", "t_std")


def temperature_stats(temp_out: Dict[str, Any], crop_output_to_outer_roi: bool
                      ) -> Dict[str, Any]:
    """Host statistics of the final temperature map over the outer ROI (or
    the full ROI) and its finite pixels, in numpy as the JAX package takes
    them."""
    tmap = temp_out["temperature_map_final"]
    troi = temp_out["roi_outer"] if crop_output_to_outer_roi else temp_out["roi_full"]
    valid = troi & np.isfinite(tmap)
    if not valid.any():
        tstats = {k: float("nan") for k in ("mean_C", "median_C", "std_C", "min_C", "max_C")}
        tstats["valid_pixels"] = 0
        return tstats
    vals = tmap[valid]
    return {
        "mean_C": float(vals.mean()),
        "median_C": float(np.median(vals)),
        "std_C": float(vals.std()),
        "min_C": float(vals.min()),
        "max_C": float(vals.max()),
        "valid_pixels": int(valid.sum()),
    }


class MultimodalPipeline:
    """frame pair -> {"force", "temperature", "temperature_stats"} on the
    device of its two pipelines (the card unless they were built for
    another)::

        mm = MultimodalPipeline(force, temperature)
        de = mm.ingest(def_bgr_u8)             # one upload, pinned
        res = mm(ref_bgr_u8, de)               # the sequential path
        sc = mm.step_fused(ref_bgr_u8, de, fetch="scalars")
    """

    def __init__(self, force: ForcePipeline, temperature: TemperaturePipeline):
        if force.ftp.device != temperature.device:
            raise ValueError(f"force runs on {force.ftp.device}, temperature on "
                             f"{temperature.device}: both must share one device")
        self.force = force
        self.temperature = temperature
        self.device = temperature.device
        self._graphs: Dict[bool, ForwardGraph] = {}

    @classmethod
    def from_artifacts(cls, data_root: str, ftp_cfg: Optional[FTPConfig] = None,
                       force_cfg: Optional[ForceConfig] = None,
                       temp_cfg: Optional[TempConfig] = None, *,
                       device="cuda") -> "MultimodalPipeline":
        """Both pipelines from the reference artifacts under ``data_root``
        (``ForcePipeline.from_artifacts``, ``TemperaturePipeline.from_artifacts``;
        the parity presets unless configurations are given), on ``device``."""
        return cls(ForcePipeline.from_artifacts(data_root, ftp_cfg, force_cfg, device=device),
                   TemperaturePipeline.from_artifacts(data_root, temp_cfg, device=device))

    def ingest(self, frame) -> torch.Tensor:
        """Upload a frame once; pass the result to ``__call__`` /
        ``step_fused`` so that both forwards read one transfer.  On the card
        the copy goes from pinned host memory; a tensor already on the
        device passes through untouched.  The span ``ingest``."""
        with profiling.span("ingest"):
            if isinstance(frame, torch.Tensor):
                return frame.to(self.device)
            host = torch.from_numpy(np.ascontiguousarray(frame))
            if self.device.type != "cuda":
                return host.to(self.device)
            # the pinned block is freed on return; PyTorch's host allocator
            # holds it until the copy on the current stream has finished
            return host.pin_memory().to(self.device, non_blocking=True)

    def _stats(self, temp_out: Dict[str, Any]) -> Dict[str, Any]:
        return temperature_stats(temp_out, self.temperature.cfg.crop_output_to_outer_roi)

    def __call__(self, ref_bgr, def_bgr) -> Dict[str, Any]:
        """The sequential path: force with the orchestrator's ROI convention
        (finite heightmap cells), then temperature, then the host stats."""
        def_bgr = self.ingest(def_bgr)
        force_out = self.force(ref_bgr, def_bgr, roi_from_finite=True)
        temp_out = self.temperature(def_bgr)
        return {
            "force": force_out,
            "temperature": temp_out,
            "temperature_stats": self._stats(temp_out),
        }

    # ------------------------------------------------------------------
    def graph_route(self) -> bool:
        """Whether ``fused_forward`` replays a CUDA graph: where both
        pipelines' forwards would replay theirs, so a force pipeline with
        debug outputs or a ``stop_after`` keeps the whole step eager."""
        return self.force.ftp.graph_route() and self.temperature.graph_route()

    def fused_forward(self, ref_bgr: torch.Tensor, def_bgr: torch.Tensor,
                      stats_only: bool = False):
        """Both modality forwards on the same device tensors, and the
        volume -> force reduction on the device: (force outputs,
        temperature outputs, force scalars), all device tensors.
        ``stats_only`` stops the temperature forward at its statistics.
        Where ``graph_route`` holds, one CUDA graph of
        ``fused_forward_eager`` for each value of ``stats_only``, captured
        at its first call and replayed at every later one; elsewhere
        ``fused_forward_eager``."""
        if self.graph_route():
            graph = self._graphs.get(stats_only)
            if graph is None:
                graph = self._graphs[stats_only] = ForwardGraph(
                    functools.partial(self.fused_forward_eager, stats_only=stats_only),
                    self.device)
            return graph(ref_bgr, def_bgr)
        with profiling.span("eager"):
            return self.fused_forward_eager(ref_bgr, def_bgr, stats_only)

    def fused_forward_eager(self, ref_bgr: torch.Tensor, def_bgr: torch.Tensor,
                            stats_only: bool = False):
        """``fused_forward`` op by op: what its CUDA graphs capture (so it
        runs both pipelines' eager forwards: a capture holds no other)."""
        fout = self.force.ftp.forward_eager(ref_bgr, def_bgr)
        tout = self.temperature.forward_eager(def_bgr, stats_only=stats_only)
        height = fout["height_map_mm_crop"]
        mm_per_px = self.force.mm_per_px_device(fout["est_period_px"])
        v, a, d = depth_map_to_volume_cm3(height, torch.isfinite(height), mm_per_px,
                                          self.force.force_cfg.depth_eps_mm)
        force_n = scalar_models.predict_force_from_volume(self.force.force_model, v,
                                                          xp=torch)
        scalars = {
            "volume_cm3": v,
            "contact_area_mm2": a,
            "max_depth_mm": d,
            "force_N": force_n,
            "mm_per_px": mm_per_px,
        }
        return fout, tout, scalars

    def step_fused(self, ref_bgr, def_bgr, fetch: str = "maps") -> Dict[str, Any]:
        """One multimodal step with shared uploads and device reductions.

        ``fetch='maps'`` returns the contract of ``__call__``;
        ``fetch='scalars'`` returns the force scalars, the temperature
        statistics (``t_*_C``, ``valid_pixels``) and the grating period as
        Python numbers, fetched in one device-to-host copy of a stacked
        tensor, and moves no map.  The span ``step_fused``, holding
        ``ingest`` a frame, ``replay`` (or ``eager``) and ``fetch``."""
        if fetch not in ("maps", "scalars"):
            raise ValueError(f"fetch must be 'maps' or 'scalars', got {fetch!r}")
        with profiling.span("step_fused"):
            fout, tout, scal = self.fused_forward(self.ingest(ref_bgr), self.ingest(def_bgr),
                                                  stats_only=fetch == "scalars")
            with profiling.span("fetch"):
                return self._fetch(fout, tout, scal, fetch)

    def _fetch(self, fout, tout, scal, fetch: str) -> Dict[str, Any]:
        names = [*scal, *(k + "_C" for k in TEMP_SCALARS), "valid_pixels",
                 "estimated_grating_period_px"]
        vals = torch.stack([t.to(torch.float64) for t in (
            *scal.values(), *(tout[k] for k in TEMP_SCALARS), tout["valid_pixels"],
            fout["est_period_px"])]).cpu().tolist()
        res = dict(zip(names, vals))
        res["valid_pixels"] = int(res["valid_pixels"])
        if fetch == "scalars":
            return res

        force_out = self.force.ftp.to_host(fout)
        force_out.update({k: res[k] for k in scal})
        temp_out = self.temperature.to_host(tout)
        return {
            "force": force_out,
            "temperature": temp_out,
            "temperature_stats": self._stats(temp_out),
        }
