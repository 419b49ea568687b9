"""Phase->height calibration trainer (JAX ``trainers/phase_to_height.py``).

The port of ``phase_to_height.py``: run the FTP engine (trainer variant:
ROI eroded by 80 px, 300 px frontier band, no plane removal, no sign flip,
unitless output) over known-depth indentations on one device (the card
unless ``device`` names another), take each image's minimum unitless height
there (three scalars fetched an image, not the map), and fit
depth_mm = f(-min_height) over the model candidates on the host; write
``calibration_model.json`` + ``calibration_results.csv`` with the reference
schema (``phase_to_height.py:1441-1583``).  Under this variant the FTP
forward launches one kernel, K3, once a frame (the demod pair's glare
repair; the hole fill is off).
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from vistaf_torch.calib import fitting
from vistaf_torch.calib.artifacts import save_json
from vistaf_torch.config import FTPConfig
from vistaf_torch.ftp.pipeline import FTPPipeline
from vistaf_torch.runner import io

# Reference trainer sample list (phase_to_height.py:36-41): real depths by
# forcing the 0-point reference.
DEFAULT_CALIBRATION_SAMPLES = (
    ("Height_0.5mm_deformed.jpg", 1.90935),
    ("Height_1mm_deformed.jpg", 1.94770),
    ("Height_1.5mm_deformed.jpg", 2.01821),
    ("Height_2mm_deformed.jpg", 2.07255),
)

MODEL_CANDIDATES = ("hinge_saturating", "growth")


def trainer_ftp_config(base: Optional[FTPConfig] = None) -> FTPConfig:
    """FTP variant used by the trainer (``phase_to_height.py:56-146``)."""
    cfg = base or FTPConfig()
    return cfg.replace(
        roi_erode_px=80,
        frontier_zero_band_px=300,
        remove_global_plane_before_detrend=False,
        auto_flip_sign=False,
        output_height_in_mm=False,
        filter_small_contact_blobs=False,
        fill_internal_holes_in_reliable=False,
    )


def compute_min_height(height_final: torch.Tensor, mask: torch.Tensor):
    """(min value, (x, y)) over the masked finite heightmap
    (``phase_to_height.py:1009-1016``), reduced on the map's device: the
    first minimum in row-major order (``np.argmin``'s tie rule), fetched
    with whether any pixel counts as three scalars in one copy."""
    m = mask & torch.isfinite(height_final)
    flat = height_final.reshape(-1)
    idx = torch.argmin(torch.where(m, height_final, torch.inf).reshape(-1))
    anyv, val, i = torch.stack([m.any().to(torch.float64), flat[idx].to(torch.float64),
                                idx.to(torch.float64)]).tolist()
    if not anyv:
        return float("nan"), None
    iy, ix = divmod(int(i), height_final.shape[-1])
    return float(val), (int(ix), int(iy))


def train(reference_path: str, samples: Sequence[Tuple[str, float]],
          deformed_dir: str, output_dir: str,
          ftp_cfg: Optional[FTPConfig] = None,
          use_negated_height: bool = True,
          anchor_origin: bool = False, origin_weight: int = 20,
          model_candidates: Sequence[str] = MODEL_CANDIDATES, *,
          device="cuda") -> Dict:
    """Run the batch calibration; returns the model JSON dict."""
    io.ensure_dir(output_dir)
    cfg = trainer_ftp_config(ftp_cfg)
    dummy_model = {"type": "linear0", "params": {"a": 1.0}}
    pipe = FTPPipeline(cfg, dummy_model, use_negated_height, device=device)

    ref = pipe.upload(io.imread_bgr(reference_path))
    rows: List[Dict] = []
    xs: List[float] = []
    ys: List[float] = []
    for fname, depth in samples:
        path = os.path.join(deformed_dir, fname)
        if not os.path.isfile(path):
            continue
        out = pipe.forward(ref, pipe.upload(io.imread_bgr(path)))
        min_val, min_xy = compute_min_height(out["height_map_unitless_crop"], pipe.roi)
        rows.append({
            "file": fname, "depth_mm": float(depth),
            "min_height_unitless": float(min_val),
            "min_x": min_xy[0] if min_xy else -1,
            "min_y": min_xy[1] if min_xy else -1,
        })
        if np.isfinite(min_val):
            xs.append(min_val)
            ys.append(float(depth))

    if len(xs) < 2:
        raise RuntimeError("Not enough valid samples to fit a model (need at least 2).")

    x = -np.asarray(xs, float) if use_negated_height else np.asarray(xs, float)
    x = np.maximum(x, 0.0)
    y = np.asarray(ys, float)
    if anchor_origin:
        w = max(1, int(origin_weight))
        x = np.concatenate([np.zeros(w), x])
        y = np.concatenate([np.zeros(w), y])

    best, summary = fitting.fit_best_model(x, y, model_candidates)

    csv_path = os.path.join(output_dir, "calibration_results.csv")
    with open(csv_path, "w", encoding="utf-8") as f:
        f.write("file,depth_mm,min_height_unitless,min_x,min_y\n")
        for r in rows:
            f.write(f"{r['file']},{r['depth_mm']},{r['min_height_unitless']},"
                    f"{r['min_x']},{r['min_y']}\n")

    model_out = {
        "reference_path": reference_path,
        "deformed_dir": deformed_dir,
        "output_dir": output_dir,
        "use_negated_height_for_fit": bool(use_negated_height),
        "x_definition": ("x = -min_height_unitless" if use_negated_height
                         else "x = min_height_unitless"),
        "best_model": {
            "type": best["type"],
            "params": best["params"],
            "equation": best["equation"],
            "r2": float(best["r2"]),
            "rmse": float(best["rmse"]),
            "sse": float(best["sse"]),
            "n": int(len(x)),
        },
        "candidates_summary": summary,
        "interpretation": (
            "This model maps unitless heightmap values to mm. "
            "If use_negated_height_for_fit=true, it uses x=-height_unitless."
        ),
    }
    save_json(os.path.join(output_dir, "calibration_model.json"), model_out)

    # calibration-curve plot (phase_to_height.py:1548-1571)
    from vistaf_torch.calib.scalar_models import predict as model_predict
    from vistaf_torch.trainers import plots
    plots.save_p2h_plot(output_dir, x, y,
                        lambda xs: model_predict(best, xs, xp=np),
                        use_negated=use_negated_height)
    return model_out
