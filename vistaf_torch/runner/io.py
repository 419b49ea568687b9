"""Host-side I/O: image decode, heightmap exports, result writers (JAX
``runner/io.py``).

Keeps the reference's on-disk contract byte-compatible where consumers exist:
``result.json`` / ``result.csv`` (``force_sensor.py:264-295``),
``height_map_*.npy/.csv`` + ``_bundle.npz`` (``shape_ftp.py:260-310``).
Every writer takes numpy arrays and Python numbers, as the pipelines'
``__call__`` returns them.  The trainers stream their series through
``iter_images_bgr``: chunks through the native batch JPEG decoder where
``runner/native.py`` loads it, else file by file with cv2.
"""
from __future__ import annotations

import csv
import json
import os
from typing import Any, Dict, Optional

import numpy as np


def imread_bgr(path: str) -> np.ndarray:
    """Decode an image to BGR uint8 on the host (same libjpeg family as the
    reference's cv2.imread, keeping inputs bit-identical)."""
    import cv2
    img = cv2.imread(path, cv2.IMREAD_COLOR)
    if img is None:
        raise RuntimeError(f"Could not read image: {path}")
    return img


def ensure_dir(p: str) -> None:
    os.makedirs(p, exist_ok=True)


def safe_float(x, fallback=float("nan")) -> float:
    try:
        v = float(x)
        if np.isfinite(v):
            return v
    except Exception:
        pass
    return float(fallback)


def export_heightmap_files(output_dir: str, basename: str,
                           height_crop: np.ndarray,
                           height_full: Optional[np.ndarray] = None,
                           crop_masks: Optional[Dict[str, np.ndarray]] = None,
                           full_masks: Optional[Dict[str, np.ndarray]] = None,
                           meta: Optional[Dict[str, Any]] = None,
                           save_crop_csv: bool = True,
                           save_full_csv: bool = False) -> None:
    """Reference export contract (``shape_ftp.py:260-310``)."""
    ensure_dir(output_dir)
    np.save(os.path.join(output_dir, f"{basename}_crop.npy"), height_crop.astype(np.float32))
    if height_full is not None:
        np.save(os.path.join(output_dir, f"{basename}_full.npy"), height_full.astype(np.float32))
    if save_crop_csv:
        np.savetxt(os.path.join(output_dir, f"{basename}_crop.csv"),
                   height_crop.astype(np.float32), delimiter=",", fmt="%.9g")
    if save_full_csv and height_full is not None:
        np.savetxt(os.path.join(output_dir, f"{basename}_full.csv"),
                   height_full.astype(np.float32), delimiter=",", fmt="%.9g")

    bundle = {"height_crop": height_crop.astype(np.float32)}
    if height_full is not None:
        bundle["height_full"] = height_full.astype(np.float32)
    for prefix, masks in (("crop_", crop_masks), ("full_", full_masks)):
        if masks:
            for k, v in masks.items():
                bundle[f"{prefix}{k}"] = np.asarray(v)
    if meta:
        for k, v in meta.items():
            bundle[f"meta_{k}"] = np.asarray(v)
    np.savez_compressed(os.path.join(output_dir, f"{basename}_bundle.npz"), **bundle)


FORCE_CSV_FIELDS = [
    "reference_path", "deformed_path", "volume_cm3", "force_N",
    "contact_area_mm2", "max_depth_mm", "mm_per_px",
    "estimated_grating_period_px", "ftp_output_dir", "force_model_type",
]


def write_force_result(output_dir: str, result: Dict[str, Any],
                       best_model: Dict[str, Any],
                       reference_path: str, deformed_path: str,
                       ftp_output_dir: str,
                       grating_pitch_mm: float, depth_eps_mm: float) -> None:
    """``result.json`` + ``result.csv`` with the reference's exact fields
    (``force_sensor.py:242-295``)."""
    ensure_dir(output_dir)
    est = result.get("estimated_grating_period_px")
    out = {
        "reference_path": reference_path,
        "deformed_path": deformed_path,
        "output_dir": output_dir,
        "ftp_output_dir": ftp_output_dir,
        "grating_pitch_mm": float(grating_pitch_mm),
        "depth_eps_mm": float(depth_eps_mm),
        "estimated_grating_period_px": None if est is None else safe_float(est),
        "mm_per_px": float(result["mm_per_px"]),
        "volume_cm3": float(result["volume_cm3"]),
        "contact_area_mm2": float(result["contact_area_mm2"]),
        "max_depth_mm": float(result["max_depth_mm"]),
        "force_N": float(result["force_N"]),
        "force_model": {
            "type": best_model.get("type", ""),
            "params": best_model.get("params", {}),
            "equation": best_model.get("equation", ""),
            "rmse": best_model.get("rmse", None),
            "r2": best_model.get("r2", None),
        },
    }
    with open(os.path.join(output_dir, "result.json"), "w", encoding="utf-8") as f:
        json.dump(out, f, indent=2)

    with open(os.path.join(output_dir, "result.csv"), "w", newline="", encoding="utf-8") as f:
        w = csv.DictWriter(f, fieldnames=FORCE_CSV_FIELDS)
        w.writeheader()
        w.writerow({
            "reference_path": reference_path,
            "deformed_path": deformed_path,
            "volume_cm3": float(result["volume_cm3"]),
            "force_N": float(result["force_N"]),
            "contact_area_mm2": float(result["contact_area_mm2"]),
            "max_depth_mm": float(result["max_depth_mm"]),
            "mm_per_px": float(result["mm_per_px"]),
            "estimated_grating_period_px": None if est is None else safe_float(est),
            "ftp_output_dir": ftp_output_dir,
            "force_model_type": best_model.get("type", ""),
        })


def crop2d(arr: np.ndarray, bbox) -> np.ndarray:
    if bbox is None:
        return arr
    y0, y1, x0, x1 = bbox
    return arr[y0:y1, x0:x1]


def write_mask_png(path: str, mask: np.ndarray, bbox=None) -> None:
    import cv2
    cv2.imwrite(path, crop2d(mask, bbox).astype(np.uint8) * 255)


def iter_images_bgr(paths, chunk: int = 8, threads: int = 0):
    """Yield (path, BGR uint8) over ``paths``, decoding JPEG chunks
    concurrently through the native libjpeg batch decoder when available
    (bit-identical to cv2.imread: tests/test_torch_native.py); any failure
    or size mismatch falls back to per-file cv2 decode, and without the
    library (``native.native_available()`` False, e.g. no libjpeg) every
    file is decoded with cv2.  Calibration trainers stream hundreds of
    native-4K frames through this (the reference decodes them serially
    inside its batch loops, height_to_force.py:384-394,
    temperature_black_model.py:271-305)."""
    paths = list(paths)
    if not paths:
        return
    try:
        from vistaf_torch.runner import native
        use_native = native.native_available()
    except Exception:
        use_native = False
    if not use_native:
        for p in paths:
            yield p, imread_bgr(p)
        return

    first = imread_bgr(paths[0])
    h, w = first.shape[:2]
    yield paths[0], first
    rest = paths[1:]
    for i in range(0, len(rest), chunk):
        batch = rest[i:i + chunk]
        try:
            stack, status = native.decode_jpeg_batch(batch, h, w, threads)
        except Exception:
            stack, status = None, None
        for j, p in enumerate(batch):
            if stack is not None and status[j] == 0:
                # copy: stack[j] is a view pinning the whole chunk buffer
                yield p, stack[j].copy()
            else:
                yield p, imread_bgr(p)
