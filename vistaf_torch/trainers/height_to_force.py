"""Volume->force calibration trainer (JAX ``trainers/height_to_force.py``).

The port of ``height_to_force.py``: run the FTP pipeline per loading image
(15 force levels x 5 frames) on one device (the card unless ``device``
names another), integrate the indentation volume there
(``pipelines/force.py::depth_map_to_volume_cm3``, as ``ForcePipeline``
does, so the volumes are its bits), fit the 6-candidate F = f(V) zoo with
origin anchoring on the host, and write the reference's incremental
CSV/JSONL (resume-by-skip) + ``calibration_model.json``
(``height_to_force.py:316-545``).
"""
from __future__ import annotations

import csv
import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from vistaf_torch.calib import fitting
from vistaf_torch.calib.artifacts import save_json
from vistaf_torch.config import ForceConfig, FTPConfig
from vistaf_torch.ftp.pipeline import FTPPipeline
from vistaf_torch.pipelines.force import depth_map_to_volume_cm3
from vistaf_torch.runner import io

FORCE_LEVELS_N = (0.5, 1.0, 2.0, 3.0, 4.0, 6.0, 8.0, 10.0, 15.0, 20.0, 25.0, 30.0, 35.0, 40.0, 45.0)
IMAGES_PER_LEVEL = 5
MODEL_CANDIDATES = ("linear0", "linear", "poly2", "sat_exp", "growth", "hinge_saturating")

CSV_FIELDS = ["file", "force_N", "volume_cm3", "contact_area_mm2", "max_depth_mm",
              "mm_per_px", "estimated_grating_period_px", "ftp_output_dir"]


def train(reference_path: str, deformed_dir: str, output_dir: str,
          p2h_model: Dict, use_negated_height: bool = True,
          ftp_cfg: Optional[FTPConfig] = None,
          force_cfg: Optional[ForceConfig] = None,
          force_levels: Sequence[float] = FORCE_LEVELS_N,
          images_per_level: int = IMAGES_PER_LEVEL,
          image_pattern: str = "sphere-{}.jpg", image_start_index: int = 1,
          anchor_origin: bool = True, origin_weight: int = 20,
          model_candidates: Sequence[str] = MODEL_CANDIDATES, *,
          device="cuda") -> Dict:
    io.ensure_dir(output_dir)
    cfg = ftp_cfg or FTPConfig()
    fcfg = force_cfg or ForceConfig()
    pipe = FTPPipeline(cfg, p2h_model, use_negated_height, device=device)
    ref = pipe.upload(io.imread_bgr(reference_path))

    csv_path = os.path.join(output_dir, "per_image_results.csv")
    jsonl_path = os.path.join(output_dir, "per_image_results.jsonl")

    # resume-by-skip (height_to_force.py:340-369)
    rows: List[Dict] = []
    processed = set()
    csv_mode = "w"
    if os.path.exists(csv_path):
        with open(csv_path, "r", newline="", encoding="utf-8") as f:
            for row in csv.DictReader(f):
                rows.append(row)
                if "file" in row:
                    processed.add(row["file"])
        csv_mode = "a"

    n_expected = len(force_levels) * images_per_level
    with open(csv_path, csv_mode, newline="", encoding="utf-8") as fcsv, \
         open(jsonl_path, "a", encoding="utf-8") as fjsonl:
        w = csv.DictWriter(fcsv, fieldnames=CSV_FIELDS)
        if csv_mode == "w":
            w.writeheader()
            fcsv.flush()

        for i in range(n_expected):
            idx = image_start_index + i
            force = float(force_levels[i // images_per_level])
            fname = image_pattern.format(idx)
            path = os.path.join(deformed_dir, fname)
            if fname in processed or not os.path.isfile(path):
                continue

            out = pipe.forward(ref, pipe.upload(io.imread_bgr(path)))

            est = float(out["est_period_px"])
            if fcfg.override_mm_per_px is not None:
                mm_per_px = float(fcfg.override_mm_per_px)
            else:
                if not np.isfinite(est) or est <= 1e-9:
                    raise RuntimeError(f"{fname}: invalid estimated_grating_period_px")
                mm_per_px = float(fcfg.grating_pitch_mm) / float(est)

            v, a, d = depth_map_to_volume_cm3(out["height_map_mm_crop"], pipe.roi,
                                              mm_per_px, fcfg.depth_eps_mm)
            v, a, d = (float(t) for t in torch.stack([v, a, d]).cpu())

            row = {
                "file": fname, "force_N": force,
                "volume_cm3": v, "contact_area_mm2": a,
                "max_depth_mm": d, "mm_per_px": mm_per_px,
                "estimated_grating_period_px": io.safe_float(est),
                "ftp_output_dir": output_dir,
            }
            w.writerow(row)
            fcsv.flush()
            fjsonl.write(json.dumps(row) + "\n")
            fjsonl.flush()
            rows.append(row)
            processed.add(fname)

    if len(rows) < 10:
        raise RuntimeError("Not enough samples processed (check paths / filenames).")

    V = np.array([float(r["volume_cm3"]) for r in rows])
    F = np.array([float(r["force_N"]) for r in rows])
    if anchor_origin:
        V_fit = np.concatenate([np.zeros(origin_weight), V])
        F_fit = np.concatenate([np.zeros(origin_weight), F])
    else:
        V_fit, F_fit = V, F

    best, summary = fitting.fit_best_model(V_fit, F_fit, model_candidates)

    model_out = {
        "reference_path": reference_path,
        "deformed_dir": deformed_dir,
        "output_dir": output_dir,
        "volume_definition": (f"V_cm3 = sum(depth_mm * (mm_per_px^2)) / 1000 over "
                              f"depth>{fcfg.depth_eps_mm}mm in ROI"),
        "grating_pitch_mm": float(fcfg.grating_pitch_mm),
        "depth_eps_mm": float(fcfg.depth_eps_mm),
        "anchor_origin": bool(anchor_origin),
        "origin_weight": int(origin_weight),
        "best_model": {
            "type": best["type"],
            "params": best["params"],
            "equation": best["equation"],
            "rmse": float(best["rmse"]),
            "r2": float(best["r2"]),
            "sse": float(best["sse"]),
            "n_fit": int(len(V_fit)),
            "n_samples": int(len(V)),
        },
        "candidates_summary": summary,
    }
    save_json(os.path.join(output_dir, "calibration_model.json"), model_out)

    # diagnostic plots (height_to_force.py:487-532)
    from vistaf_torch.calib.scalar_models import predict as model_predict
    from vistaf_torch.trainers import plots
    plots.save_h2f_plots(output_dir, rows,
                         lambda xs: model_predict(best, xs, xp=np),
                         list(force_levels))
    return model_out
