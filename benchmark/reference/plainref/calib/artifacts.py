"""Calibration artifact I/O (JAX ``calib/artifacts.py``), the reference's
JSON schemas as they are: ``calibration_model.json`` holds ``best_model
{type, params, equation, rmse, r2, ...}``.  json and os only."""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Tuple


def load_phase_to_height(json_path: str) -> Tuple[Dict[str, Any], bool]:
    """(best_model, use_negated_height) of a phase-to-height calibration."""
    with open(json_path, "r", encoding="utf-8") as f:
        cal = json.load(f)
    model = cal["best_model"]
    use_neg = bool(cal.get("use_negated_height_for_fit", True))
    return model, use_neg


def load_force_calibration(json_path: str) -> Dict[str, Any]:
    """The whole force-calibration dict; raises if ``best_model`` is missing."""
    with open(json_path, "r", encoding="utf-8") as f:
        data = json.load(f)
    if "best_model" not in data:
        raise ValueError("Invalid force calibration JSON: missing 'best_model'")
    return data


def save_json(path: str, obj: Dict[str, Any]) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        json.dump(obj, f, indent=2)


def load_json(path: str) -> Dict[str, Any]:
    with open(path, "r", encoding="utf-8") as f:
        return json.load(f)


def load_json_safe(path: str):
    """The JSON at ``path``, or None where it is missing or cannot be read
    or parsed."""
    if not os.path.exists(path):
        return None
    try:
        return load_json(path)
    except (OSError, ValueError):
        return None
