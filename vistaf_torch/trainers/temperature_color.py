"""Colored-TLC temperature calibration trainer (JAX
``trainers/temperature_color.py``), its masked means and Huber fits on one
device (the card unless ``device`` names another).

The port of ``temperature_color_model.py``: per-image mean (L, a, b)
over the fixed annulus ROI for heating + cooling sequences, fit range
20-33 °C, Huber-poly models with GroupKFold degree selection and isotonic
prediction calibration; writes equations txt, metrics JSON, joblib bundles
and our plain-weight .npz exports (``temperature_color_model.py:652-965``).
"""
from __future__ import annotations

import os
from typing import Dict, Sequence

import numpy as np

from vistaf_torch.calib.artifacts import save_json
from vistaf_torch.calib.huber import fit_huber_poly
from vistaf_torch.calib.isotonic import fit_isotonic, isotonic_predict
from vistaf_torch.runner import io
from vistaf_torch.trainers import temperature_common as tc

TEMPS_HEATING = tuple(range(20, 40)) + tuple(range(40, 76, 5))
FRAMES_PER_TEMP = 5
USE_FEATURES = ("L", "a", "b")
POLY_DEGREE_CANDIDATES = (1, 2, 3, 4)
CV_SPLITS = 6
HUBER_EPSILON = 1.2
HUBER_ALPHA = 1e-6
FIT_TEMP_RANGE = (20.0, 33.0)

INNER_CIRCLE = ((1881, 1749), (1579, 665), (2616, 936))
OUTER_CIRCLE = ((1803, 1990), (1393, 496), (2856, 860))


def train(heating_pattern: str, cooling_pattern: str, out_dir: str,
          temps_heating: Sequence[float] = TEMPS_HEATING,
          frames_per_temp: int = FRAMES_PER_TEMP,
          fit_temp_range=FIT_TEMP_RANGE,
          use_isotonic: bool = True,
          degree_candidates: Sequence[int] = POLY_DEGREE_CANDIDATES,
          cv_splits: int = CV_SPLITS,
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
    heat_feats = tc.mean_features_for_sequence(heating_files, mask, with_gray=False,
                                                device=device)
    cool_feats = tc.mean_features_for_sequence(cooling_files, mask, with_gray=False,
                                                device=device)

    y_heat_full = np.repeat(np.asarray(temps_heating, float), frames_per_temp)
    y_cool_full = np.repeat(np.asarray(temps_cooling, float), frames_per_temp)

    def apply_range(X, y):
        if fit_temp_range is None:
            return X, y
        sel = (y >= fit_temp_range[0]) & (y <= fit_temp_range[1])
        return X[sel], y[sel]

    X_heat, y_heat = apply_range(heat_feats, y_heat_full)
    X_cool, y_cool = apply_range(cool_feats, y_cool_full)

    def fit_variant(X, y, name):
        groups = y.astype(int)
        deg = tc.choose_degree_by_groupcv(X, y, groups, degree_candidates,
                                          cv_splits, HUBER_EPSILON, HUBER_ALPHA,
                                          device=device)
        model = fit_huber_poly(X, y, degree=deg, epsilon=HUBER_EPSILON, alpha=HUBER_ALPHA,
                               device=device)
        pred_raw = model.predict(X)
        iso = fit_isotonic(pred_raw, y) if use_isotonic else None
        pred = isotonic_predict(iso[0], iso[1], pred_raw) if iso else pred_raw
        weights = tc.pipeline_to_weights(model, name, USE_FEATURES, iso)
        uniq, pred_means = tc.per_temp_mean_pred(y, pred)
        return {
            "degree": deg,
            "weights": weights,
            "pred": pred,
            "uniq_T": uniq,
            "pred_means": pred_means,
            "metrics_frames": tc.compute_metrics(y, pred),
            "metrics_means": tc.compute_metrics(uniq, pred_means),
        }

    heating = fit_variant(X_heat, y_heat, "color_model_heating")
    cooling = fit_variant(X_cool, y_cool, "color_model_cooling")
    X_all = np.vstack([X_heat, X_cool])
    y_all = np.concatenate([y_heat, y_cool])
    global_ = fit_variant(X_all, y_all, "color_model")

    eqs = {k: tc.equation_string(v["weights"]) for k, v in
           (("heating", heating), ("cooling", cooling), ("global", global_))}

    with open(os.path.join(out_dir, "equations_color_models_final.txt"), "w", encoding="utf-8") as f:
        f.write(f"FINAL MODEL (HEATING)  T = f(L,a,b)\nDegree={heating['degree']}\n{eqs['heating']}\n\n")
        f.write(f"FINAL MODEL (COOLING)  T = f(L,a,b)\nDegree={cooling['degree']}\n{eqs['cooling']}\n\n")
        f.write(f"FINAL MODEL (GLOBAL / MERGED)  T = f(L,a,b)\nDegree={global_['degree']}\n{eqs['global']}\n")

    summary = {
        "output_dir": os.path.abspath(out_dir),
        "use_features": list(USE_FEATURES),
        "frames_per_temp": int(frames_per_temp),
        "poly_degree_candidates": list(degree_candidates),
        "auto_select_degree": True,
        "fit_temp_range": None if fit_temp_range is None else list(map(float, fit_temp_range)),
        "use_isotonic_calibration": bool(use_isotonic),
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
        stem = f"color_model_{name}_huber_deg{v['degree']}" if name != "global" \
            else f"color_model_global_huber_deg{v['degree']}"
        v["weights"].save_npz(os.path.join(out_dir, stem + ".npz"))
        tc.export_joblib_bundle(os.path.join(out_dir, stem + ".joblib"),
                                v["weights"], fit_temp_range)

    # diagnostic figures + per-temp error CSV 00-08
    # (temperature_color_model.py:668-672, 836-935)
    from vistaf_torch.trainers import plots
    Ly = "Mean LAB L in ROI"
    plots.save_annulus_roi_overlay(os.path.join(out_dir, "00_roi_overlay.png"),
                                   first, mask, inner_circle, outer_circle)
    plots.plot_feat_vs_T_run(os.path.join(out_dir, "01_heating_L_vs_T_modelcurve.png"),
                             "Color TLC Heating Model — LAB L vs T", Ly,
                             plots.COLOR_HEAT, y_heat_full, heat_feats[:, 0])
    plots.plot_feat_vs_T_run(os.path.join(out_dir, "02_cooling_L_vs_T_modelcurve.png"),
                             "Color TLC Cooling Model — LAB L vs T", Ly,
                             plots.COLOR_COOL, y_cool_full, cool_feats[:, 0])
    plots.plot_hysteresis(os.path.join(out_dir, "03_hysteresis_L_vs_T_models.png"),
                          "Color TLC Hysteresis Model (Heating vs Cooling) — "
                          "LAB L vs Temperature", Ly,
                          y_heat_full, heat_feats[:, 0], y_cool_full, cool_feats[:, 0])
    gp = global_["pred"]
    nh = len(y_heat)
    plots.plot_true_vs_pred(os.path.join(out_dir, "05_global_true_vs_pred.png"),
                            "Color TLC Global Model — Measured vs Predicted Temperature",
                            y_heat, gp[:nh], y_cool, gp[nh:],
                            global_["uniq_T"], global_["pred_means"])
    plots.plot_feat_vs_T_all(os.path.join(out_dir, "06_global_L_vs_T_all_trend.png"),
                             "Color TLC Global Model — LAB L vs T", Ly,
                             y_heat_full, heat_feats[:, 0], y_cool_full, cool_feats[:, 0])
    plots.save_per_temp_error_csv(os.path.join(out_dir, "07_global_per_temp_error.csv"),
                                  y_all, gp, "global")
    plots.plot_per_temp_mae(os.path.join(out_dir, "08_global_mae_vs_T.png"),
                            y_all, gp, "Color TLC Global Model — MAE vs Temperature")
    return summary
