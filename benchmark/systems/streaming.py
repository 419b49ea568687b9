"""The stream batch under test: ``StreamingForce`` over ``BatchedForce``
(``vistaf_torch.pipelines.streaming``, ``vistaf_torch.parallel``), the
configuration's ``streams`` skin cameras each with its own reference frame,
the smoothing ``window`` and ``ema_alpha``.

Each stream has its own skin (texture, noise) and its own pool of
deformed frames, one a depth of the traffic's ``depths_rad`` (0: the skin
at rest), the dent's place jittered by ``at_jitter`` of the circle's radius
from the seed.  A ring of ``ring`` batches is drawn from the pools once
(stream s of batch b: a scene of stream s's pool), so that a call takes a
ready (S, H, W, 3) host array.

Entries: ``step``, ``StreamingForce.__call__(refs, batch)`` (one batch a
call, its outputs as numpy); ``ahead``, ``StreamingForce.run_overlapped(refs,
batches)`` over ``sequence`` batches a call.
"""
from __future__ import annotations

import gc
from typing import Dict, Iterator, List

import numpy as np
import torch

from harness import scenes as sc
from harness.window import Call
from refcheck import stream_expected, stream_gaps, verdict
from refrun import stream_forces


class System:
    def __init__(self, cfg: Dict, traffic: Dict, seed: int, device, clock,
                 program: bool = True):
        self.cfg, self.traffic, self.seed, self.device = cfg, traffic, int(seed), device
        self.seq = int(traffic.get("sequence", 1))
        self.frames_per_call = cfg["streams"] * self.seq
        if program and torch.device(device).type == "cuda":
            from vistaf_torch import kernels
            with clock("library"):
                kernels.library()
        with clock("scenes"):
            self.refs, self.pool, self.ring = self._scenes()
        if program:
            with clock("pipelines"):
                self.sf = self._pipeline()
            self.entry = {"step": self._step, "ahead": self._ahead}[traffic["entry"]]

    def _scenes(self):
        h, w = self.cfg["frame"]
        s_n = int(self.cfg["streams"])
        pts = [tuple(p) for p in (self.cfg["ftp"]["outer_circle_p1"],
                                  self.cfg["ftp"]["outer_circle_p2"],
                                  self.cfg["ftp"]["outer_circle_p3"])]
        t = self.traffic
        depths = [float(d) for d in t["depths_rad"]]
        rng = np.random.default_rng([self.seed, 0])
        jit = float(t.get("at_jitter", 0.0))
        refs, pool = [], []
        with torch.no_grad():
            for s in range(s_n):
                dents = [{"depth_rad": d, "at": tuple(rng.uniform(-jit, jit, 2))}
                         for d in depths]
                g = sc.generator(self.seed, 1 + s, self.device)
                gray = sc.grating_frames(h, w, pts, dents, g, self.device,
                                         t.get("period_px", 12.0), t.get("texture", 0.1))
                frames = sc.bgr(gray).cpu().numpy()
                refs.append(frames[0])
                pool.append(frames[1:])
        refs, pool = np.stack(refs), np.stack(pool)
        # the ring: batch b's stream s shows scene ring[b, s] of its pool
        ring = rng.integers(0, len(depths), size=(int(t.get("ring", 32)), s_n))
        self.batches = [np.ascontiguousarray(pool[np.arange(s_n), ring[b]])
                        for b in range(len(ring))]
        return refs, pool, ring

    def _pipeline(self):
        from vistaf_torch.config import ftp_config_from_dict
        from vistaf_torch.ftp.pipeline import FTPPipeline
        from vistaf_torch.parallel import BatchedForce
        from vistaf_torch.pipelines.streaming import StreamingForce
        c = self.cfg
        bf = BatchedForce(FTPPipeline(ftp_config_from_dict(c["ftp"]), c["p2h_model"],
                                      device=self.device), c["force_model"],
                          grating_pitch_mm=float(c.get("grating_pitch_mm", 2.0)),
                          depth_eps_mm=float(c.get("depth_eps_mm", 0.01)))
        return StreamingForce(bf, int(c["streams"]), window=int(c["window"]),
                              ema_alpha=float(c["ema_alpha"]))

    def _step(self, b: List[int]) -> List[Dict]:
        return [self.sf(self.refs, self.batches[b[0]])]

    def _ahead(self, b: List[int]) -> List[Dict]:
        return self.sf.run_overlapped(self.refs, [self.batches[i] for i in b])

    def schedule(self, rng: np.random.Generator) -> Iterator[List[int]]:
        """Each call's ring batches, drawn uniformly from the seed."""
        n = len(self.batches)
        while True:
            yield [int(i) for i in rng.integers(0, n, self.seq)]

    def warm_inputs(self) -> List[List[int]]:
        """The capture, and two more calls of replays."""
        n = len(self.batches)
        return [[(3 * k + i) % n for i in range(self.seq)] for k in range(3)]

    def settle(self) -> None:
        """Back to no frames seen, so the window's first step starts the
        smoothing that the reference works out again."""
        self.sf.reset()

    def free(self) -> None:
        del self.sf
        gc.collect()
        if torch.device(self.device).type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()

    def reference(self, tf32: bool = False) -> Dict[str, np.ndarray]:
        return stream_forces(self.cfg, self.refs, self.pool, self.device, tf32=tf32,
                             chunk=int(self.traffic.get("reference_chunk", 8)))

    def answers(self, calls):
        """The window's steps in order: (outputs, (T, S) scene indices)."""
        outs = [o for c in calls for o in c.out]
        scenes = np.asarray([self.ring[b] for c in calls for b in c.scenes], np.int64)
        return outs, scenes.reshape(-1, int(self.cfg["streams"]))

    def as_calls(self, answers: Dict[str, np.ndarray], schedule, n: int) -> List[Call]:
        """``n`` calls of the schedule answered by another computation's raw
        forces and depths (the control), its smoothing worked out from
        them."""
        bs = [next(schedule) for _ in range(n)]
        scenes = np.asarray([self.ring[b] for c in bs for b in c], np.int64)
        exp = stream_expected(scenes, answers["force_raw_N"], answers["max_depth_mm"],
                              int(self.cfg["window"]), float(self.cfg["ema_alpha"]))
        steps = [{k: v[t] for k, v in exp.items()} for t in range(len(scenes))]
        return [Call(0.0, 0.0, self.frames_per_call, c,
                     steps[i * self.seq:(i + 1) * self.seq]) for i, c in enumerate(bs)]

    def check(self, calls, reference=None) -> Dict:
        ref = self.reference() if reference is None else reference
        outs, scenes = self.answers(calls)
        exp = stream_expected(scenes, ref["force_raw_N"], ref["max_depth_mm"],
                              int(self.cfg["window"]), float(self.cfg["ema_alpha"]))
        gaps = stream_gaps(outs, exp, ref["force_raw_N"], ref["max_depth_mm"])
        return {**verdict(gaps, self.cfg["limits"]), "gaps": gaps}
