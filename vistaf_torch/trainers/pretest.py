"""Thermal-stabilization pretest analysis (JAX ``trainers/pretest.py``),
the per-frame LAB and masked mean on one device (the card unless ``device``
names another).

The port of ``pretest_25to30.py`` / ``pretest_30to31.py`` (SURVEY.md
C17): mean LAB-L inside an ROI per frame of a time series (dt = 20 s), and
detection of the stabilization time — the first window of ``window``
consecutive points within max(tol_frac * total_change, tol_abs) of the final
mean.

Note the reference scripts point at ``./Pretest/...`` while the data lives in
``Temperature/Pretest_Stable_Time/{25to30,30to31}/`` — the default pattern
here uses the real location.
"""
from __future__ import annotations

import glob
import os
import re
from typing import Dict, List, Optional, Sequence

import numpy as np

DEFAULT_DT_S = 20.0


def load_series_sorted(pattern: str) -> List[str]:
    files = glob.glob(pattern)
    if not files:
        raise RuntimeError(f"No files found for pattern: {pattern}")

    def key(p):
        m = re.search(r"(\d+)\.[A-Za-z]+$", os.path.basename(p))
        return int(m.group(1)) if m else os.path.basename(p)

    return sorted(files, key=key)


def mean_L_series(files: Sequence[str], roi_mask: np.ndarray, *,
                  device="cuda") -> np.ndarray:
    """Per-frame mean LAB-L inside the ROI: the port's unfused 8-bit LAB
    (``ops/color.py::bgr_to_lab_u8``) and the float32 masked mean on
    ``device``, one scalar fetched a frame."""
    import cv2
    import torch
    from vistaf_torch.ops.color import bgr_to_lab_u8
    from vistaf_torch.trainers.temperature_common import masked_means_f32

    mask = torch.as_tensor(roi_mask, device=device)
    out = []
    for p in files:
        img = cv2.imread(p, cv2.IMREAD_COLOR)
        if img is None:
            raise RuntimeError(f"Could not read image: {p}")
        L = bgr_to_lab_u8(torch.as_tensor(img, device=device))[..., 0]
        out.append(float(masked_means_f32(L[None], mask)[0]))
    return np.asarray(out)


def detect_stabilization_time(values: np.ndarray, dt_s: float = DEFAULT_DT_S,
                              window: int = 5, tol_frac: float = 0.02,
                              tol_abs: float = 1.0) -> Optional[Dict]:
    """First window of ``window`` consecutive points all within
    max(tol_frac * |total change|, tol_abs) of the final mean
    (``pretest_25to30.py:83-116``)."""
    v = np.asarray(values, float)
    if len(v) < window:
        return None
    final = float(np.mean(v[-window:]))
    total_change = abs(final - float(v[0]))
    tol = max(tol_frac * total_change, tol_abs)
    for i in range(0, len(v) - window + 1):
        if np.all(np.abs(v[i:i + window] - final) <= tol):
            return {
                "index": int(i),
                "time_s": float(i * dt_s),
                "final_mean_L": final,
                "tolerance": float(tol),
                "total_change": float(total_change),
            }
    return None


def analyze(pattern: str, roi_mask: np.ndarray, dt_s: float = DEFAULT_DT_S,
            out_dir: Optional[str] = None, label: Optional[str] = None, *,
            device="cuda") -> Dict:
    """Run the pretest series analysis; with ``out_dir``, also save the
    reference's result figure (``Figure_1_pretest_<label>.png``, matching the
    committed ``Temperature/Pretest_Stable_Time/Figure_1_pretest_*.png``)."""
    files = load_series_sorted(pattern)
    series = mean_L_series(files, roi_mask, device=device)
    stab = detect_stabilization_time(series, dt_s=dt_s)
    out = {
        "n_frames": len(files),
        "dt_s": dt_s,
        "mean_L": series.tolist(),
        "stabilization": stab,
    }
    if out_dir is not None:
        from vistaf_torch.trainers import plots
        os.makedirs(out_dir, exist_ok=True)
        name = label or "series"
        fig_path = os.path.join(out_dir, f"Figure_1_pretest_{name}.png")
        times = np.arange(len(series)) * dt_s
        plots.save_pretest_figure(fig_path, times, series,
                                  stab["time_s"] if stab else None, name)
        out["figure_path"] = fig_path
    return out
