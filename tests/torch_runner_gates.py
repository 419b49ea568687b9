"""Shared comparison of an output tree written by the port's runner with one
written by the JAX runner (imported by ``test_torch_runner.py`` and
``test_torch_cli.py``).

Where the inputs are the same arrays the two trees must be the same bytes
(JSON, CSV) or the same decoded pixels (PNG).  Where each package computed
its own maps from the same frames, the gates are the multimodal parity
test's (``test_torch_multimodal_parity.py``): force, volume, area, depth and
scale within 1%; t_mean and the median within 0.1 degC; t_min and t_max
within 0.75 degC; valid pixels within 0.5%.  JSON documents must have the
same keys and the same JSON types at every level, after the output root is
replaced by a placeholder and the ``timestamp`` field, checked to be an ISO
time, by another.
"""
import json
import os
from datetime import datetime

import cv2
import numpy as np

FORCE_RTOL = 0.01
T_MEAN_ATOL, T_EXTREME_ATOL, VALID_RTOL = 0.1, 0.75, 0.005
FORCE_READINGS = ("force_N", "volume_cm3", "contact_area_mm2", "max_depth_mm",
                  "scale_mm_per_px")
RESULT_NUMBERS = ("estimated_grating_period_px", "mm_per_px", "volume_cm3",
                  "contact_area_mm2", "max_depth_mm", "force_N")


def tree(root) -> set:
    """Relative paths of every file under ``root``."""
    out = set()
    for d, _, files in os.walk(root):
        for f in files:
            out.add(os.path.relpath(os.path.join(d, f), root))
    return out


def load_json(path):
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def normalise(obj, root):
    """``obj`` with every string under ``root`` rebased on ``<OUT>`` and the
    ``timestamp`` value (an ISO time) replaced by ``<TIME>``."""
    root = str(root)
    if isinstance(obj, dict):
        out = {}
        for k, v in obj.items():
            if k == "timestamp":
                datetime.fromisoformat(v)
                out[k] = "<TIME>"
            else:
                out[k] = normalise(v, root)
        return out
    if isinstance(obj, list):
        return [normalise(v, root) for v in obj]
    if isinstance(obj, str) and obj.startswith(root):
        return "<OUT>" + obj[len(root):]
    return obj


def assert_same_types(a, b, where="$"):
    """The same keys and the same JSON types (int, float, str, None, list,
    dict) at every level."""
    assert type(a) is type(b), (where, type(a), type(b), a, b)
    if isinstance(a, dict):
        assert set(a) == set(b), (where, set(a) ^ set(b))
        for k in a:
            assert_same_types(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same_types(x, y, f"{where}[{i}]")


def assert_close_rel(got, want, rtol, where):
    assert abs(got - want) <= rtol * abs(want), (where, got, want)


def assert_readings_within_gates(got, want):
    """``sensor_readings`` of a port summary against the JAX one."""
    for k in FORCE_READINGS:
        assert_close_rel(got["force"][k], want["force"][k], FORCE_RTOL, k)
    t, j = got["temperature"], want["temperature"]
    assert abs(t["mean_C"] - j["mean_C"]) <= T_MEAN_ATOL, (t, j)
    assert abs(t["median_C"] - j["median_C"]) <= T_MEAN_ATOL, (t, j)
    assert abs(t["min_C"] - j["min_C"]) <= T_EXTREME_ATOL, (t, j)
    assert abs(t["max_C"] - j["max_C"]) <= T_EXTREME_ATOL, (t, j)
    assert t["valid_pixels"] > 0
    assert abs(t["valid_pixels"] - j["valid_pixels"]) <= VALID_RTOL * j["valid_pixels"], (t, j)


def assert_result_json_within_gates(got, want, got_root, want_root):
    """A port ``result.json`` against the JAX one: equal after the roots
    are normalised, but for its numbers, each within 1%."""
    g, w = normalise(got, got_root), normalise(want, want_root)
    assert_same_types(g, w)
    for k in RESULT_NUMBERS:
        assert_close_rel(g.pop(k), w.pop(k), FORCE_RTOL, k)
    assert g == w


def png(path) -> np.ndarray:
    img = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
    assert img is not None, path
    return img


def assert_same_pngs(dir_a, dir_b, names):
    for name in names:
        np.testing.assert_array_equal(png(os.path.join(dir_a, name)),
                                      png(os.path.join(dir_b, name)), err_msg=name)


def read_bytes(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()
