"""Black/mixed-TLC temperature calibration trainer (JAX
``trainers/temperature_black.py``), its masked means, pixel gathers and
Huber fits on one device (the card unless ``device`` names another).

The port of ``temperature_black_model.py``: trains on random
per-pixel (L, a, b, gray) samples (4000/image, saturation-excluded) so the
model matches per-pixel inference, but — like the reference — selects the
polynomial degree by GroupKFold CV over *frame-mean* features
(``temperature_black_model.py:715``) and reports metrics on frame-mean /
per-temp-mean features (``temperature_black_model.py:770-806, 852-866``).
Degrees {1,2,3}; no isotonic.
"""
from __future__ import annotations

import os
from typing import Dict, Sequence

import numpy as np

from vistaf_torch.calib.artifacts import save_json
from vistaf_torch.calib.huber import fit_huber_poly
from vistaf_torch.runner import io
from vistaf_torch.trainers import temperature_common as tc

TEMPS_HEATING = tuple(range(20, 51)) + tuple(range(55, 76, 5))
FRAMES_PER_TEMP = 5
USE_FEATURES = ("L", "a", "b", "gray")
POLY_DEGREE_CANDIDATES = (1, 2, 3)
CV_SPLITS = 6
HUBER_EPSILON = 1.2
HUBER_ALPHA = 1e-4
PIXELS_PER_IMAGE = 4000
MAX_TOTAL_PIXEL_SAMPLES = 1_500_000

INNER_CIRCLE = ((1881, 1749), (1579, 665), (2616, 936))
OUTER_CIRCLE = ((1803, 1990), (1393, 496), (2856, 860))


def train(heating_pattern: str, cooling_pattern: str, out_dir: str,
          temps_heating: Sequence[float] = TEMPS_HEATING,
          frames_per_temp: int = FRAMES_PER_TEMP,
          degree_candidates: Sequence[int] = POLY_DEGREE_CANDIDATES,
          cv_splits: int = CV_SPLITS,
          pixels_per_image: int = PIXELS_PER_IMAGE,
          max_total_samples: int = MAX_TOTAL_PIXEL_SAMPLES,
          seed: int = 0,
          inner_circle=INNER_CIRCLE, outer_circle=OUTER_CIRCLE, *,
          device="cuda") -> Dict:
    io.ensure_dir(out_dir)
    import cv2
    heating_files = tc.load_images_sorted(heating_pattern)
    cooling_files = tc.load_images_sorted(cooling_pattern)
    first = cv2.imread(heating_files[0], cv2.IMREAD_COLOR)
    h, w = first.shape[:2]
    mask = tc.annulus_roi(h, w, inner_circle, outer_circle)

    temps_cooling = tuple(reversed(tuple(temps_heating)))
    y_heat_full = np.repeat(np.asarray(temps_heating, float), frames_per_temp)
    y_cool_full = np.repeat(np.asarray(temps_cooling, float), frames_per_temp)

    # pixel-sample training sets (temperature_black_model.py:242-305)
    X_heat_px, y_heat_px = tc.pixel_samples_for_sequence(
        heating_files, mask, y_heat_full, pixels_per_image, max_total_samples, seed,
        device=device)
    # cooling uses seed+1 (temperature_black_model.py:747)
    X_cool_px, y_cool_px = tc.pixel_samples_for_sequence(
        cooling_files, mask, y_cool_full, pixels_per_image, max_total_samples, seed + 1,
        device=device)

    # frame-mean features for degree selection + metrics
    heat_mean = tc.mean_features_for_sequence(heating_files, mask, with_gray=True,
                                              device=device)
    cool_mean = tc.mean_features_for_sequence(cooling_files, mask, with_gray=True,
                                              device=device)

    def per_temp_feature_means(feats, temps):
        _, blocks = tc.group_by_temperature(feats, temps, frames_per_temp)
        return np.stack([b.mean(axis=0) for b in blocks])

    heat_temp_means = per_temp_feature_means(heat_mean, temps_heating)
    cool_temp_means = per_temp_feature_means(cool_mean, temps_cooling)

    def fit_variant(X_px, y_px, X_frames, y_frames, X_means, temps, name):
        groups = y_frames.astype(int)
        deg = tc.choose_degree_by_groupcv(X_frames, y_frames, groups,
                                          degree_candidates, cv_splits,
                                          HUBER_EPSILON, HUBER_ALPHA, device=device)
        model = fit_huber_poly(X_px, y_px, degree=deg,
                               epsilon=HUBER_EPSILON, alpha=HUBER_ALPHA, device=device)
        weights = tc.pipeline_to_weights(model, name, USE_FEATURES, None)
        pred_frames = model.predict(X_frames)
        pred_means = model.predict(X_means)
        return {
            "degree": deg,
            "weights": weights,
            "pred_frames": pred_frames,
            "metrics_frames": tc.compute_metrics(y_frames, pred_frames),
            "metrics_means": tc.compute_metrics(np.asarray(temps, float), pred_means),
        }

    heating = fit_variant(X_heat_px, y_heat_px, heat_mean, y_heat_full,
                          heat_temp_means, temps_heating, "black_model_heating")
    cooling = fit_variant(X_cool_px, y_cool_px, cool_mean, y_cool_full,
                          cool_temp_means, temps_cooling, "black_model_cooling")
    # global per-temp means merge heating+cooling frames per unique temp
    # (temperature_black_model.py:796-805)
    X_all_frames = np.vstack([heat_mean, cool_mean])
    y_all_frames = np.concatenate([y_heat_full, y_cool_full])
    uniq_T = np.array(sorted(set(y_all_frames.astype(int).tolist())), float)
    X_all_means = np.stack([X_all_frames[y_all_frames.astype(int) == int(t)].mean(axis=0)
                            for t in uniq_T])
    global_ = fit_variant(
        np.vstack([X_heat_px, X_cool_px]), np.concatenate([y_heat_px, y_cool_px]),
        X_all_frames, y_all_frames, X_all_means, uniq_T, "wide_model")

    eqs = {k: tc.equation_string(v["weights"]) for k, v in
           (("heating", heating), ("cooling", cooling), ("global", global_))}

    with open(os.path.join(out_dir, "equations_black_models_final.txt"), "w", encoding="utf-8") as f:
        f.write(f"FINAL MODEL (HEATING)  T = f(L,a,b,gray)\nDegree={heating['degree']}\n{eqs['heating']}\n\n")
        f.write(f"FINAL MODEL (COOLING)  T = f(L,a,b,gray)\nDegree={cooling['degree']}\n{eqs['cooling']}\n\n")
        f.write(f"FINAL MODEL (GLOBAL / MERGED)  T = f(L,a,b,gray)\nDegree={global_['degree']}\n{eqs['global']}\n")

    summary = {
        "output_dir": os.path.abspath(out_dir),
        "use_features": list(USE_FEATURES),
        "frames_per_temp": int(frames_per_temp),
        "poly_degree_candidates": list(degree_candidates),
        "auto_select_degree": True,
        "train_on_pixel_samples": True,
        "pixels_per_image": int(pixels_per_image),
        "huber": {"epsilon": HUBER_EPSILON, "alpha": HUBER_ALPHA, "max_iter": 10000},
        "models_final": {
            name: {
                "degree": int(v["degree"]),
                "equation": eqs[name],
                "metrics_frames": v["metrics_frames"],
                "metrics_means": v["metrics_means"],
            } for name, v in (("heating", heating), ("cooling", cooling), ("global", global_))
        },
    }
    save_json(os.path.join(out_dir, "models_final_summary_metrics.json"), summary)

    for name, v in (("heating", heating), ("cooling", cooling), ("global", global_)):
        stem = f"black_model_{name}_huber_deg{v['degree']}" if name != "global" \
            else f"black_model_global_huber_deg{v['degree']}"
        v["weights"].save_npz(os.path.join(out_dir, stem + ".npz"))
        tc.export_joblib_bundle(
            os.path.join(out_dir, stem + ".joblib"), v["weights"], None,
            extra={"training_mode": "pixel_samples",
                   "pixel_sampling": {"pixels_per_image": int(pixels_per_image),
                                      "max_total": int(max_total_samples),
                                      "seed": int(seed)}})

    # diagnostic figures 00-06 (temperature_black_model.py:871-957)
    from vistaf_torch.trainers import plots
    gy = "Mean gray in ROI"
    plots.save_annulus_roi_overlay(os.path.join(out_dir, "00_roi_overlay.png"),
                                   first, mask, inner_circle, outer_circle)
    plots.plot_feat_vs_T_run(os.path.join(out_dir, "01_heating_gray_vs_T_modelcurve.png"),
                             "Black TLC Heating Model — gray vs T", gy,
                             plots.COLOR_HEAT, y_heat_full, heat_mean[:, 3])
    plots.plot_feat_vs_T_run(os.path.join(out_dir, "02_cooling_gray_vs_T_modelcurve.png"),
                             "Black TLC Cooling Model — gray vs T", gy,
                             plots.COLOR_COOL, y_cool_full, cool_mean[:, 3])
    plots.plot_hysteresis(os.path.join(out_dir, "03_hysteresis_gray_vs_T_models.png"),
                          "Black TLC Hysteresis Model (Heating vs Cooling) — gray vs T",
                          gy, y_heat_full, heat_mean[:, 3], y_cool_full, cool_mean[:, 3])
    gp = global_["pred_frames"]
    nh = len(y_heat_full)
    plots.plot_true_vs_pred(os.path.join(out_dir, "05_global_true_vs_pred.png"),
                            "Black TLC Global Model — Measured vs Predicted Temperature",
                            y_heat_full, gp[:nh], y_cool_full, gp[nh:])
    plots.plot_feat_vs_T_all(os.path.join(out_dir, "06_global_gray_vs_T_all_modelcurve.png"),
                             "Black TLC Global Model — gray vs T", gy,
                             y_heat_full, heat_mean[:, 3], y_cool_full, cool_mean[:, 3])
    return summary
