"""The numbers that decide ``correct``: each answer the program gave in the
window against the plain reference's answer to the same inputs.

Every number is the worst over the answers compared; an answer fails where
any of its gaps is above its limit.  Relative gaps are taken against the
reference's largest magnitude of that output over the cell's scenes (full
scale), so an output near zero (a skin at rest) is not divided by itself.
A NaN on one side only is an infinite gap.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from refrun import smooth

MM_FORCE_KEYS = ("force_N", "volume_cm3", "contact_area_mm2", "max_depth_mm", "mm_per_px",
                 "estimated_grating_period_px")
MM_TEMP_KEYS = ("t_mean_C", "t_min_C", "t_max_C", "t_std_C")
STREAM_FORCE_KEYS = ("force_raw_N", "force_median_N", "force_mean_N", "force_ema_N")


def _gap(a, b, scale=1.0) -> np.ndarray:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    both = np.isnan(a) & np.isnan(b)
    g = np.abs(a - b) / scale
    g = np.where(np.isnan(g), np.inf, g)
    return np.where(both, 0.0, g)


def _scale(values) -> float:
    v = np.abs(np.asarray(values, np.float64))
    v = v[np.isfinite(v)]
    return float(v.max()) if v.size and v.max() > 0 else 1.0


def multimodal_gaps(answers: Sequence[Dict], scenes: Sequence[int],
                    reference: Sequence[Dict]) -> Dict[str, np.ndarray]:
    """Per answer: ``force_gap``, the largest relative gap of the force
    scalars (force, volume, contact area, depth, mm per px, grating
    period); ``temp_gap_C``, the largest gap of the temperature statistics
    in degC; ``valid_gap``, the gap of the valid pixel count, relative."""
    scale = {k: _scale([r[k] for r in reference]) for k in MM_FORCE_KEYS + ("valid_pixels",)}
    out = {"force_gap": [], "temp_gap_C": [], "valid_gap": []}
    for a, s in zip(answers, scenes):
        r = reference[s]
        out["force_gap"].append(max(float(_gap(a[k], r[k], scale[k])) for k in MM_FORCE_KEYS))
        out["temp_gap_C"].append(max(float(_gap(a[k], r[k])) for k in MM_TEMP_KEYS))
        out["valid_gap"].append(float(_gap(a["valid_pixels"], r["valid_pixels"],
                                           scale["valid_pixels"])))
    return {k: np.asarray(v, np.float64) for k, v in out.items()}


def stream_expected(scenes: np.ndarray, raw: np.ndarray, depth: np.ndarray, window: int,
                    ema_alpha: float) -> Dict[str, np.ndarray]:
    """Every step's outputs, worked out again: the raw forces and depths of
    each stream's scene at each step (``scenes`` (T, S) indices into the
    (S, K) ``raw`` and ``depth``), and the smoothing state carried through
    them from no frames seen."""
    s_idx = np.arange(raw.shape[0])[None, :]
    seq = raw[s_idx, scenes]
    return {"force_raw_N": seq, "max_depth_mm": depth[s_idx, scenes],
            **smooth(seq, window, ema_alpha)}


def stream_gaps(answers: Sequence[Dict], expected: Dict[str, np.ndarray],
                raw: np.ndarray, depth: np.ndarray) -> Dict[str, np.ndarray]:
    """Per step: ``force_gap``, the largest gap of the raw, median, mean
    and EMA forces (relative to the largest raw force of the scenes), the
    total (relative to the streams' count times it) and the depths
    (relative to the largest depth); ``contact_flips``, the streams whose
    contact state differs; ``force_gap_median``, the median over the steps
    of ``force_gap`` (the same for every step: a steady number beside the
    widest gap, which a threshold in the forward can swing)."""
    f_scale, d_scale = _scale(raw), _scale(depth)
    n = raw.shape[0]
    force, flips = [], []
    for t, a in enumerate(answers):
        g = max(float(np.max(_gap(a[k], expected[k][t], f_scale))) for k in STREAM_FORCE_KEYS)
        g = max(g, float(_gap(a["total_force_N"], expected["total_force_N"][t], n * f_scale)),
                float(np.max(_gap(a["max_depth_mm"], expected["max_depth_mm"][t], d_scale))))
        force.append(g)
        flips.append(int(np.sum(np.asarray(a["in_contact"], bool)
                                != expected["in_contact"][t])))
    force = np.asarray(force, np.float64)
    return {"force_gap": force, "contact_flips": np.asarray(flips, np.float64),
            "force_gap_median": np.full(force.shape, np.median(force) if force.size else 0.0)}


def verdict(gaps: Dict[str, np.ndarray], limits: Dict[str, float]) -> Dict:
    """Each compared number (the worst answer's gap) beside its limit, the
    answers compared, the answers that fail, and whether all are within."""
    n = len(next(iter(gaps.values()))) if gaps else 0
    bad = np.zeros(n, bool)
    numbers = {}
    for name, lim in limits.items():
        g = gaps[name]
        bad |= ~(g <= lim)
        numbers[name] = {"value": float(np.max(g)) if g.size else None, "limit": float(lim)}
    return {"numbers": numbers, "compared": n, "failed": int(bad.sum()),
            "correct": bool(n > 0 and not bad.any())}
