"""The multimodal pipeline under test: one skin camera's BGR frame through
FTP force and TLC temperature (``vistaf_torch.pipelines.multimodal``),
built from a configuration's ``ftp``, ``temp``, ``force``, ``p2h_model``
and ``force_model``; the temperature models drawn from the seed.

Entries: ``scalars``, ``MultimodalPipeline.step_fused(ref, def,
fetch='scalars')`` on host uint8 frames, one frame a call.  The traffic's
``scenes`` are the deformed frames' pool (each a dent's ``depth_rad`` and
``at``, and the hot spot's ``hot``); the reference frame is the skin at
rest under ``reference_hot``.
"""
from __future__ import annotations

import gc
from typing import Dict, Iterator, List

import numpy as np
import torch

from harness import scenes as sc
from harness.window import Call
from refcheck import multimodal_gaps, verdict
from refrun import multimodal_scalars


class System:
    frames_per_call = 1

    def __init__(self, cfg: Dict, traffic: Dict, seed: int, device, clock,
                 program: bool = True):
        self.cfg, self.traffic, self.seed, self.device = cfg, traffic, int(seed), device
        if program and torch.device(device).type == "cuda":
            from vistaf_torch import kernels
            with clock("library"):
                kernels.library()
        with clock("scenes"):
            self.ref, self.pool = self._scenes()
        if program:
            with clock("pipelines"):
                self.mm = self._pipeline()
            self.entry = {"scalars": self._scalars}[traffic["entry"]]

    def _scenes(self):
        h, w = self.cfg["frame"]
        fpts = [tuple(p) for p in (self.cfg["ftp"]["outer_circle_p1"],
                                   self.cfg["ftp"]["outer_circle_p2"],
                                   self.cfg["ftp"]["outer_circle_p3"])]
        tpts = [tuple(p) for p in (self.cfg["temp"]["outer_circle_p1"],
                                   self.cfg["temp"]["outer_circle_p2"],
                                   self.cfg["temp"]["outer_circle_p3"])]
        t = self.traffic
        g = sc.generator(self.seed, 0, self.device)
        with torch.no_grad():
            gray = sc.grating_frames(h, w, fpts, t["scenes"], g, self.device,
                                     t.get("period_px", 12.0), t.get("texture", 0.1))
            frames = [sc.compose(gray[0], sc.tlc_frame(h, w, tpts, t["reference_hot"], g,
                                                       self.device))]
            for k, s in enumerate(t["scenes"], start=1):
                frames.append(sc.compose(gray[k], sc.tlc_frame(h, w, tpts, s["hot"], g,
                                                               self.device)))
            host = [f.cpu().numpy() for f in frames]
        del gray, frames
        return host[0], host[1:]

    def models(self):
        return sc.temp_model_arrays(self.seed)

    def _pipeline(self):
        from vistaf_torch.calib.temp_weights import TempModelWeights
        from vistaf_torch.config import ForceConfig, ftp_config_from_dict, temp_config_from_dict
        from vistaf_torch.pipelines.force import ForcePipeline
        from vistaf_torch.pipelines.multimodal import MultimodalPipeline
        from vistaf_torch.temperature.inference import TemperaturePipeline
        color, wide = (TempModelWeights(**m) for m in self.models())
        c = self.cfg
        return MultimodalPipeline(
            ForcePipeline(ftp_config_from_dict(c["ftp"]), ForceConfig(**c.get("force", {})),
                          c["p2h_model"], c["force_model"], device=self.device),
            TemperaturePipeline(temp_config_from_dict(c["temp"]), color, wide,
                                device=self.device))

    def _scalars(self, k: int) -> Dict:
        return self.mm.step_fused(self.ref, self.pool[k], fetch="scalars")

    def schedule(self, rng: np.random.Generator) -> Iterator[int]:
        """The scenes in seeded order: each pass over the pool a fresh
        shuffle, so every seed sends every scene equally often."""
        n = len(self.pool)
        while True:
            yield from (int(i) for i in rng.permutation(n))

    def warm_inputs(self) -> List[int]:
        """Every scene once: the capture and the graph's replays of each."""
        return list(range(len(self.pool)))

    def settle(self) -> None:
        """Nothing carries from one call to the next."""

    def free(self) -> None:
        del self.mm
        gc.collect()
        if torch.device(self.device).type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()

    def reference(self, tf32: bool = False) -> List[Dict]:
        return multimodal_scalars(self.cfg, self.models(), self.ref, self.pool, self.device,
                                  tf32=tf32)

    def as_calls(self, answers: List[Dict], schedule, n: int) -> List[Call]:
        """``n`` calls of the schedule answered by another computation's
        per-scene ``answers`` (the control)."""
        ks = [next(schedule) for _ in range(n)]
        return [Call(0.0, 0.0, 1, k, answers[k]) for k in ks]

    def check(self, calls, reference=None) -> Dict:
        ref = self.reference() if reference is None else reference
        gaps = multimodal_gaps([c.out for c in calls], [c.scenes for c in calls], ref)
        return {**verdict(gaps, self.cfg["limits"]), "gaps": gaps}
