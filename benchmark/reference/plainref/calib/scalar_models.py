"""Scalar calibration models y = f(x) (JAX ``calib/scalar_models.py``).

Parameters travel as the reference's JSON dicts ``{"type": ..., "params":
{...}}``.  ``predict`` evaluates on a float32 tensor (``xp=torch``) or on
numpy / Python floats (``xp=np``, float64).
"""
from __future__ import annotations

import math
from typing import Any, Dict

import numpy as np
import torch


def _ops(xp):
    if xp is torch:
        return torch.exp, lambda x: torch.clamp(x, min=0.0)
    return np.exp, lambda x: np.maximum(x, 0.0)


def predict(model: Dict[str, Any], x, xp=torch):
    """Evaluate a fitted scalar model at x, minus its optional
    ``origin_correction``."""
    t = model["type"]
    p = model["params"]
    offset = float(model.get("origin_correction", 0.0))
    x = (x.to(torch.float32) if isinstance(x, torch.Tensor)
         else torch.as_tensor(x, dtype=torch.float32)) if xp is torch else np.asarray(x, float)
    exp, relu = _ops(xp)

    if t in ("linear0", "linear_through_origin"):
        out = float(p["a"]) * x
    elif t == "linear":
        out = float(p["a"]) * x + float(p["b"])
    elif t == "poly2":
        c0, c1, c2 = float(p["c0"]), float(p["c1"]), float(p["c2"])
        out = c2 * x * x + c1 * x + c0
    elif t == "exp":
        out = float(p["a"]) * exp(float(p["b"]) * x)
    elif t == "power":
        out = float(p["a"]) * x ** float(p["b"])
    elif t == "sat_exp":
        out = float(p["a"]) * (1.0 - exp(-float(p["b"]) * relu(x)))
    elif t == "sat_exp_shift":
        a, b, x0 = float(p["a"]), float(p["b"]), float(p["x0"])
        g = 1.0 - exp(-b * relu(x - x0))
        out = a * (g - (1.0 - math.exp(-b * max(0.0 - x0, 0.0))))
    elif t == "growth":
        # force-sensor semantics clamp the argument at 0
        out = float(p["a"]) * (exp(float(p["b"]) * relu(x)) - 1.0)
    elif t == "hinge_saturating":
        a, b, c = float(p["a"]), float(p["b"]), float(p["c"])
        g = 1.0 - exp(-b * relu(x - c))
        out = a * (g - (1.0 - math.exp(-b * max(0.0 - c, 0.0))))
    else:
        raise ValueError(f"Unknown model type: {t}")
    return out - offset


def predict_force_from_volume(model: Dict[str, Any], volume_cm3, xp=torch):
    """Force model with the force sensor's x >= 0 clamp semantics."""
    return predict(model, volume_cm3, xp=xp)


def height_unitless_to_depth_mm(height_unitless: torch.Tensor, model: Dict[str, Any],
                                use_negated_height: bool = True) -> torch.Tensor:
    """Unitless FTP height -> depth in mm: f(max(-h, 0)) (or f(max(h, 0)))."""
    h = height_unitless.to(torch.float32)
    x = torch.clamp(-h if use_negated_height else h, min=0.0)
    return predict(model, x, xp=torch)
