"""Multimodal session runner: directory tree, summary JSON, artifact copies
(JAX ``runner/session.py``).

File-contract parity with ``multimodal_sensor.py``: a timestamped
``session_*/{force_sensing,temperature_sensing,combined_outputs}`` tree,
``multimodal_summary.json`` with the same schema (sensor readings + all four
calibration-performance blocks), force ``result.json/.csv``, temperature
``.npy`` maps + mask PNGs + colormap/overlay/legend figures.  The pipeline
is the port's ``MultimodalPipeline`` on whatever device it was built for;
the writers run on the host over its numpy outputs.
"""
from __future__ import annotations

import os
import shutil
from datetime import datetime
from typing import Any, Dict, Optional

import numpy as np

from vistaf_torch import config as C
from vistaf_torch.calib.artifacts import load_json_safe
from vistaf_torch.config import SessionConfig
from vistaf_torch.pipelines.multimodal import MultimodalPipeline
from vistaf_torch.runner import figures, io


def safe_float(x, fallback=float("nan")):
    return io.safe_float(x, fallback)


# ---------------------------------------------------------------------------
# Metric extraction (multimodal_sensor.py:214-279)
# ---------------------------------------------------------------------------

def extract_phase_to_height_metrics(calib: Optional[Dict]) -> Dict[str, Any]:
    if calib is None:
        return {}
    best = calib.get("best_model", {})
    return {
        "calibration_type": "phase_to_height",
        "model_type": best.get("type", "unknown"),
        "equation": best.get("equation", ""),
        "r2": safe_float(best.get("r2", np.nan)),
        "rmse": safe_float(best.get("rmse", np.nan)),
        "n_samples": int(best.get("n", 0)),
        "x_definition": calib.get("x_definition", ""),
    }


def extract_height_to_force_metrics(calib: Optional[Dict]) -> Dict[str, Any]:
    if calib is None:
        return {}
    best = calib.get("best_model", {})
    return {
        "calibration_type": "height_to_force",
        "model_type": best.get("type", "unknown"),
        "equation": best.get("equation", ""),
        "r2": safe_float(best.get("r2", np.nan)),
        "rmse": safe_float(best.get("rmse", np.nan)),
        "n_fit": int(best.get("n_fit", 0)),
        "n_samples": int(best.get("n_samples", 0)),
        "volume_definition": calib.get("volume_definition", ""),
    }


def extract_temp_model_metrics(calib: Optional[Dict], model_name: str) -> Dict[str, Any]:
    if calib is None:
        return {}
    models = calib.get("models_final", {})
    if model_name not in models:
        return {}
    m = models[model_name]
    frames = m.get("metrics_frames", {})
    means = m.get("metrics_means", {})

    def block(src):
        return {
            "rmse_C": safe_float(src.get("rmse_C", np.nan)),
            "mae_C": safe_float(src.get("mae_C", np.nan)),
            "r2": safe_float(src.get("r2", np.nan)),
            "max_abs_err_C": safe_float(src.get("max_abs_err_C", np.nan)),
            "p95_abs_err_C": safe_float(src.get("p95_abs_err_C", np.nan)),
            "n": int(src.get("n", 0)),
        }

    return {
        "model": model_name,
        "degree": int(m.get("degree", 0)),
        "equation": m.get("equation", ""),
        "frames": block(frames),
        "means": block(means),
    }


# ---------------------------------------------------------------------------
# Session
# ---------------------------------------------------------------------------

def run_session(pipeline: MultimodalPipeline, reference_image: str,
                deformed_image: str, data_root: str,
                cfg: Optional[SessionConfig] = None,
                timestamp: Optional[str] = None) -> Dict[str, Any]:
    """Run force + temperature on one frame pair and write the full session
    artifact tree.  Returns the summary dict (also written as
    ``combined_outputs/multimodal_summary.json``)."""
    cfg = cfg or SessionConfig()
    ts = timestamp or datetime.now().strftime("%Y%m%d_%H%M%S")
    session_dir = os.path.join(cfg.output_root, f"session_{ts}")
    force_dir = os.path.join(session_dir, "force_sensing")
    temp_dir = os.path.join(session_dir, "temperature_sensing")
    combined_dir = os.path.join(session_dir, "combined_outputs")
    for d in (session_dir, force_dir, temp_dir, combined_dir):
        io.ensure_dir(d)
    ftp_out_dir = os.path.join(force_dir, "ftp_run")
    io.ensure_dir(ftp_out_dir)

    ref_bgr = io.imread_bgr(reference_image)
    def_bgr = io.imread_bgr(deformed_image)
    # the deformed frame feeds both modality forwards: ingest it once (one
    # pinned upload on the card); def_bgr stays host-side for the figure
    # writers
    def_dev = pipeline.ingest(def_bgr)

    out = (pipeline.step_fused(ref_bgr, def_dev) if cfg.fused_step
           else pipeline(ref_bgr, def_dev))
    f = out["force"]
    t = out["temperature"]
    tstats = out["temperature_stats"]

    # ---- force artifacts ----
    io.write_force_result(
        force_dir, f, pipeline.force.force_model,
        reference_image, deformed_image, ftp_out_dir,
        pipeline.force.force_cfg.grating_pitch_mm,
        pipeline.force.force_cfg.depth_eps_mm)

    if cfg.export_heightmaps:
        H, W = ref_bgr.shape[:2]
        x1, x2, y1, y2 = f["crop_bbox"]
        height_full = np.full((H, W), np.nan, np.float32)
        height_full[y1:y2, x1:x2] = f["height_map_mm_crop"]
        io.export_heightmap_files(
            ftp_out_dir, "height_map", f["height_map_mm_crop"], height_full,
            crop_masks={
                "roi_eroded": f["roi_eroded_crop"],
                "reliable": f["reliable_crop"],
                "output_reliable": f["output_reliable_crop"],
                "circ_mask": f["circ_mask_crop"],
                "contact_kept_by_depth": f["contact_kept_crop"],
                "contact_dilated": f["contact_dilated_crop"],
            },
            meta={
                "crop_x1": np.int32(x1), "crop_y1": np.int32(y1),
                "crop_x2": np.int32(x2), "crop_y2": np.int32(y2),
            })

    if cfg.save_summary_figures:
        height_vis = f["height_map_mm_crop"].copy()
        height_vis[~f["roi_eroded_crop"]] = np.nan
        phase_vis = f["height_map_unitless_crop"].copy()
        phase_vis[~f["output_reliable_crop"]] = np.nan
        figures.save_phase_and_height_panel(ftp_out_dir, phase_vis, height_vis,
                                            f["circ_mask_crop"])
        figures.save_force_shape_right_panel(combined_dir, height_vis, f["force_N"])
        figures.save_heightmap_3d(combined_dir, f["height_map_mm_crop"],
                                  np.isfinite(f["height_map_mm_crop"]),
                                  f"3D Heightmap - Force: {f['force_N']:.2f} N")

    # ---- temperature artifacts ----
    np.save(os.path.join(temp_dir, "temperature_map_fused.npy"),
            t["temperature_map_fused"].astype(np.float32))
    np.save(os.path.join(temp_dir, "temperature_map_final.npy"),
            t["temperature_map_final"].astype(np.float32))
    bbox = t["crop_bbox"]
    for name, key in [("mask_roi.png", "roi_full"), ("mask_roi_eff.png", "mask_roi_eff"),
                      ("mask_sat.png", "mask_sat"), ("mask_dark.png", "mask_dark"),
                      ("mask_light.png", "mask_light"),
                      ("mask_color_support.png", "mask_color_support"),
                      ("mask_color_ok.png", "mask_color_ok")]:
        io.write_mask_png(os.path.join(temp_dir, name), t[key], bbox)

    tcfg = pipeline.temperature.cfg
    stats_roi = t["roi_outer"] if tcfg.crop_output_to_outer_roi else t["roi_full"]
    if cfg.save_summary_figures:
        figures.save_temperature_colormap(
            temp_dir, io.crop2d(t["temperature_map_fused"], bbox), io.crop2d(stats_roi, bbox),
            "temperature_map_fused_colormap.png", tcfg.final_t_min, tcfg.final_t_max)
        title = f"Temperature map - min: {tstats['min_C']:.2f} °C, max: {tstats['max_C']:.2f} °C"
        figures.save_temperature_colormap(
            temp_dir, io.crop2d(t["temperature_map_final"], bbox), io.crop2d(stats_roi, bbox),
            "temperature_map_final_colormap.png", tcfg.final_t_min, tcfg.final_t_max, title=title)
        figures.save_temperature_overlay(
            temp_dir, io.crop2d(def_bgr, bbox),
            io.crop2d(t["temperature_map_final"], bbox), io.crop2d(stats_roi, bbox),
            "temperature_map_final_colormap_overlay.png", tcfg.final_t_min, tcfg.final_t_max)
        figures.save_horizontal_legend(temp_dir, tcfg.final_t_min, tcfg.final_t_max)

    # ---- combined summary (multimodal_sensor.py:592-646) ----
    p2h_calib = load_json_safe(os.path.join(data_root, C.PHASE_TO_HEIGHT_JSON))
    h2f_calib = load_json_safe(os.path.join(data_root, C.HEIGHT_TO_FORCE_JSON))
    color_calib = load_json_safe(os.path.join(data_root, C.TEMP_COLOR_METRICS_JSON))
    black_calib = load_json_safe(os.path.join(data_root, C.TEMP_BLACK_METRICS_JSON))

    summary = {
        "session_id": ts,
        "timestamp": datetime.now().isoformat(),
        "input_images": {"reference": reference_image, "deformed": deformed_image},
        "output_directory": session_dir,
        "sensor_readings": {
            "force": {
                "force_N": f["force_N"],
                "volume_cm3": f["volume_cm3"],
                "contact_area_mm2": f["contact_area_mm2"],
                "max_depth_mm": f["max_depth_mm"],
                "scale_mm_per_px": f["mm_per_px"],
            },
            "temperature": tstats,
        },
        "calibration_performance": {
            "phase_to_height": extract_phase_to_height_metrics(p2h_calib),
            "height_to_force": extract_height_to_force_metrics(h2f_calib),
            "temperature_color_model": {
                name: extract_temp_model_metrics(color_calib, name)
                for name in ("heating", "cooling", "global")
            } if color_calib else {},
            "temperature_black_model": {
                name: extract_temp_model_metrics(black_calib, name)
                for name in ("heating", "cooling", "global")
            } if black_calib else {},
        },
        "file_paths": {
            "force_subdir": force_dir,
            "temperature_subdir": temp_dir,
            "combined_subdir": combined_dir,
        },
    }

    import json
    with open(os.path.join(combined_dir, "multimodal_summary.json"), "w", encoding="utf-8") as fj:
        json.dump(summary, fj, indent=2)

    # artifact copies (multimodal_sensor.py:649-665)
    for fname in ("result.json", "result.csv"):
        src = os.path.join(force_dir, fname)
        if os.path.exists(src):
            shutil.copy2(src, os.path.join(combined_dir, f"force_{fname}"))
    for fname in ("temperature_map_final_colormap.png",
                  "temperature_map_final_colormap_overlay.png",
                  "temperature_legend_horizontal.png"):
        src = os.path.join(temp_dir, fname)
        if os.path.exists(src):
            shutil.copy2(src, os.path.join(combined_dir, f"temp_{fname}"))

    # optional interactive 3-D heightmap window, closed by the user
    # (multimodal_sensor.py:670-679)
    if cfg.show_3d_interactive:
        figures.show_heightmap_3d_interactive(
            f["height_map_mm_crop"], np.isfinite(f["height_map_mm_crop"]),
            f"3D Heightmap (Interactive) - Force: {f['force_N']:.2f} N")

    return summary
