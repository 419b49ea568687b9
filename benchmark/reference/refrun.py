"""The plain reference of the benchmark's systems, on the inputs the
benchmark made: ``plainref`` (a frozen copy of the port's plain paths, no
hand-written kernel, no CUDA graph, every loop a host ``while``) and numpy.
It imports nothing of the program under test; it is given the same host
frames and configuration dicts as the program, and works every derived
table out again.

``tf32`` runs it one precision below the configuration's float32 (the
matmuls and convolutions in TF32): the control that the comparison has to
fail.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, Sequence

import numpy as np
import torch

from plainref.calib.temp_weights import TempModelWeights
from plainref.config import (ForceConfig, ftp_config_from_dict, temp_config_from_dict)
from plainref.ftp.pipeline import FTPPipeline
from plainref.pipelines.force import ForcePipeline, depth_map_to_volume_cm3
from plainref.pipelines.multimodal import MultimodalPipeline
from plainref.calib import scalar_models
from plainref.temperature.inference import TemperaturePipeline


@contextlib.contextmanager
def precision(tf32: bool):
    """Float32 matmuls and convolutions in full float32, or in TF32."""
    m, c = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = bool(tf32)
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = m, c


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def multimodal_scalars(cfg: Dict, models: Sequence[Dict], ref: np.ndarray,
                       defs: Sequence[np.ndarray], device, tf32: bool = False) -> List[Dict]:
    """``MultimodalPipeline.step_fused(ref, d, fetch='scalars')`` of the
    plain path for each deformed frame of ``defs``: the force scalars, the
    temperature statistics and the grating period."""
    fcfg = ftp_config_from_dict(cfg["ftp"])
    tcfg = temp_config_from_dict(cfg["temp"])
    color, wide = (TempModelWeights(**m) for m in models)
    mm = MultimodalPipeline(
        ForcePipeline(fcfg, ForceConfig(**cfg.get("force", {})), cfg["p2h_model"],
                      cfg["force_model"], device=device),
        TemperaturePipeline(tcfg, color, wide, device=device))
    out = []
    with precision(tf32), torch.no_grad():
        r = torch.as_tensor(np.ascontiguousarray(ref), device=device)
        for d in defs:
            out.append(mm.step_fused(r, torch.as_tensor(np.ascontiguousarray(d), device=device),
                                     fetch="scalars"))
    _sync(device)
    del mm
    return out


def stream_forces(cfg: Dict, refs: np.ndarray, pool: np.ndarray, device,
                  tf32: bool = False, chunk: int = 8) -> Dict[str, np.ndarray]:
    """Each stream's raw force and maximum depth for each of its scenes:
    ``refs`` (S, H, W, 3), ``pool`` (S, K, H, W, 3) uint8; returns (S, K)
    float32 arrays.  The forward and the volume -> force tail of
    ``BatchedForce`` (a 2 mm grating pitch, a 0.01 mm contact threshold, a
    1e-9 floor on the period), ``chunk`` frames a forward."""
    pipe = FTPPipeline(ftp_config_from_dict(cfg["ftp"]), cfg["p2h_model"], device=device)
    s, k = pool.shape[:2]
    pairs = [(i, j) for i in range(s) for j in range(k)]
    force = np.zeros((s, k), np.float32)
    depth = np.zeros((s, k), np.float32)
    pitch, eps = float(cfg.get("grating_pitch_mm", 2.0)), float(cfg.get("depth_eps_mm", 0.01))
    with precision(tf32), torch.no_grad():
        for c0 in range(0, len(pairs), chunk):
            part = pairs[c0:c0 + chunk]
            r = torch.as_tensor(np.stack([refs[i] for i, _ in part]), device=device)
            d = torch.as_tensor(np.stack([pool[i, j] for i, j in part]), device=device)
            res = pipe.forward_eager(r, d)
            height = res["height_map_mm_crop"]
            mm_per_px = pitch / torch.clamp(res["est_period_px"], min=1e-9)
            v, _, dep = depth_map_to_volume_cm3(height, torch.isfinite(height), mm_per_px, eps,
                                                streams=True)
            f = scalar_models.predict_force_from_volume(cfg["force_model"], v)
            for (i, j), fv, dv in zip(part, f.cpu().numpy(), dep.cpu().numpy()):
                force[i, j], depth[i, j] = fv, dv
    _sync(device)
    del pipe
    return {"force_raw_N": force, "max_depth_mm": depth}


def _sum_in_order(x: np.ndarray) -> np.float32:
    total = x[0]
    for v in x[1:]:
        total = np.float32(total + v)
    return np.float32(total)


def smooth(raw: np.ndarray, window: int, ema_alpha: float, contact_on_n: float = 0.3,
           contact_off_n: float = 0.1) -> Dict[str, np.ndarray]:
    """The streaming state carried through a sequence of raw forces (T, S),
    from no frames seen: each step writes the forces into ring slot
    count % window; the mean and median over the filled slots (the median
    the sorted filled slots' element (filled - 1) // 2), the EMA from the
    first forces, contact on above ``contact_on_n`` and off at or below
    ``contact_off_n`` of the median, the total the streams' medians summed
    in order; all in float32.  Returns each output as (T, ...)."""
    raw = np.asarray(raw, np.float32)
    t_n, s = raw.shape
    ring = np.zeros((s, window), np.float32)
    ema = np.zeros(s, np.float32)
    contact = np.zeros(s, bool)
    a = np.float32(ema_alpha)
    keep = np.float32(1.0 - ema_alpha)        # as the program's (1.0 - alpha) * ema
    out = {k: [] for k in ("force_mean_N", "force_median_N", "force_ema_N", "in_contact",
                           "total_force_N")}
    for t in range(t_n):
        f = raw[t]
        ring[:, t % window] = f
        filled = min(t + 1, window)
        vals = ring[:, :filled]
        mean = np.zeros(s, np.float32)
        for j in range(filled):
            mean = (mean + vals[:, j]).astype(np.float32)
        mean = (mean / np.float32(filled)).astype(np.float32)
        median = np.sort(vals, axis=1)[:, (filled - 1) // 2].astype(np.float32)
        ema = f.copy() if t == 0 else (keep * ema + a * f).astype(np.float32)
        contact = np.where(contact, median > contact_off_n, median > contact_on_n)
        out["force_mean_N"].append(mean)
        out["force_median_N"].append(median)
        out["force_ema_N"].append(ema)
        out["in_contact"].append(contact.copy())
        out["total_force_N"].append(_sum_in_order(median))
    return {k: np.asarray(v) for k, v in out.items()}
