"""Shared machinery for the TLC temperature-model trainers (JAX
``trainers/temperature_common.py``).

Covers the common skeleton of ``temperature_color_model.py`` and
``temperature_black_model.py``: sorted sequence loading, annulus-ROI feature
extraction (cv2 integer LAB on the host, masked means and pixel gathers on
the device), GroupKFold degree selection with the Huber-poly trainer on the
device, metrics, equation strings, and artifact export (the plain-weight
.npz, and a sklearn-compatible joblib bundle where sklearn and joblib are
present, so the reference inference scripts keep working).
"""
from __future__ import annotations

import glob
import os
import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from vistaf_torch.calib import groupkfold
from vistaf_torch.calib.huber import HuberPolyPipeline, fit_huber_poly
from vistaf_torch.calib.temp_weights import TempModelWeights
from vistaf_torch.ops import geometry


def sort_key_by_index(path: str):
    base = os.path.basename(path)
    m = re.search(r"-(\d+)\.", base)
    return int(m.group(1)) if m else base


def load_images_sorted(pattern: str) -> List[str]:
    files = glob.glob(pattern)
    if not files:
        raise RuntimeError(f"No files found for pattern: {pattern}")
    files.sort(key=sort_key_by_index)
    return files


def annulus_roi(h: int, w: int, inner_pts, outer_pts) -> np.ndarray:
    inner = geometry.circle_from_3_points_exact(*inner_pts)
    outer = geometry.circle_from_3_points_exact(*outer_pts)
    if outer[2] <= inner[2]:
        raise RuntimeError("Invalid annulus: outer radius must be larger than inner radius.")
    return geometry.annulus_mask(h, w, inner, outer)


# ---------------------------------------------------------------------------
# Feature extraction
# ---------------------------------------------------------------------------

def feature_planes_u8(img_bgr: np.ndarray) -> np.ndarray:
    """(4, H, W) uint8 planes L, a, b, gray in OpenCV's integer convention
    (the JAX ``_feature_planes_device``, which returns them as float32).

    The temperature models' feature scales are tiny (the black model's a/b
    std is ~2-3 LAB units), so trainer features must be bit-identical to the
    cv2 integer LAB the reference trained on: a ±1 LSB float approximation
    measurably shifts GroupKFold degree selection (deg3 -> deg2 on the black
    global model).  Training is an offline host batch job, so cv2 takes the
    conversion on the host; the inference path keeps the device's float LAB.
    """
    import cv2
    lab = cv2.cvtColor(img_bgr, cv2.COLOR_BGR2LAB)
    gray = cv2.cvtColor(img_bgr, cv2.COLOR_BGR2GRAY)
    return np.concatenate([lab.transpose(2, 0, 1), gray[None]], axis=0)


def masked_means_f32(planes: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """(P,) float32 means of integer-valued planes (P, H, W) over ``mask``,
    as the JAX trainers' float32 ``sum(where(mask, x, 0)) / sum(mask)``,
    which XLA compiles, the mask being a constant, to a multiply by the
    float32 reciprocal of the count.  The sums are taken exactly (int64)
    and rounded to float32 once: JAX's float32 sum is exact while its
    partial sums stay below 2^24, and beyond that (a 4K annulus) an exact
    sum makes the card's and the CPU's means the same bits."""
    inv_n = torch.reciprocal(mask.sum().to(torch.float32))
    s = torch.where(mask, planes.to(torch.int64), 0).sum(dim=(-2, -1))
    return s.to(torch.float32) * inv_n


def mean_features_for_sequence(files: Sequence[str], mask: np.ndarray,
                               with_gray: bool = False, *, device="cuda") -> np.ndarray:
    """Per-image mean (L, a, b[, gray]) inside the ROI
    (``temperature_color_model.py:208-228``), the means on ``device``."""
    from vistaf_torch.runner.io import iter_images_bgr
    mask_d = torch.as_tensor(mask, device=device)
    feats = []
    shape0 = None
    for path, img in iter_images_bgr(files):
        if img is None:
            raise RuntimeError(f"Could not read image: {path}")
        if shape0 is None:
            shape0 = img.shape[:2]
        elif img.shape[:2] != shape0:
            raise RuntimeError(f"Image size mismatch for {path}")
        planes = torch.as_tensor(feature_planes_u8(img), device=device)
        feats.append(masked_means_f32(planes, mask_d))
    if not feats:
        return np.asarray([], float)
    out = torch.stack(feats).cpu().numpy().astype(float)
    return out if with_gray else out[:, :3]


def pixel_samples_for_sequence(files: Sequence[str], mask: np.ndarray,
                               y_frames: np.ndarray, pixels_per_image: int,
                               max_total: int, seed: int = 0,
                               exclude_saturated: bool = True,
                               sat_thresh: int = 245, *,
                               device="cuda") -> Tuple[np.ndarray, np.ndarray]:
    """Random per-pixel (L, a, b, gray) samples
    (``temperature_black_model.py:242-305``): the valid mask and the gather
    on ``device`` (``torch.nonzero`` lists pixels in ``np.argwhere``'s
    row-major order), the draw on the host with the JAX trainer's
    ``np.random.default_rng(seed)`` calls, so both pick the same pixels."""
    from vistaf_torch.runner.io import iter_images_bgr
    rng = np.random.default_rng(seed)
    mask_d = torch.as_tensor(mask, device=device)
    X_list, y_list = [], []
    total = 0
    for i, (path, img) in enumerate(iter_images_bgr(files)):
        if img is None:
            raise RuntimeError(f"Could not read image: {path}")
        planes = torch.as_tensor(feature_planes_u8(img), device=device)
        valid = mask_d
        if exclude_saturated:
            valid = valid & (planes[3] < sat_thresh)
        flat = torch.nonzero(valid.reshape(-1)).reshape(-1)
        count = int(flat.numel())
        if count == 0:
            continue
        if count > pixels_per_image:
            sel = rng.choice(count, size=pixels_per_image, replace=False)
            flat = flat[torch.as_tensor(sel, device=device)]
        Xi = planes.reshape(4, -1)[:, flat].T.to(torch.float32).cpu().numpy()
        X_list.append(Xi)
        y_list.append(np.full(Xi.shape[0], float(y_frames[i]), np.float32))
        total += Xi.shape[0]
        if total >= max_total:
            break
    if not X_list:
        raise RuntimeError("No pixel samples collected.")
    return np.vstack(X_list), np.concatenate(y_list)


def group_by_temperature(features: np.ndarray, temps: Sequence[float],
                         frames_per_temp: int):
    n_temps = len(temps)
    if features.shape[0] != n_temps * frames_per_temp:
        raise RuntimeError(
            f"Images ({features.shape[0]}) != {n_temps} temps x {frames_per_temp} frames")
    blocks = [features[i * frames_per_temp:(i + 1) * frames_per_temp]
              for i in range(n_temps)]
    return np.asarray(temps, float), blocks


# ---------------------------------------------------------------------------
# Metrics (temperature_color_model.py:258-276)
# ---------------------------------------------------------------------------

def compute_metrics(y_true, y_pred) -> Dict[str, float]:
    y_true = np.asarray(y_true, float)
    y_pred = np.asarray(y_pred, float)
    abs_err = np.abs(y_true - y_pred)
    ss_res = float(np.sum((y_true - y_pred) ** 2))
    ss_tot = float(np.sum((y_true - y_true.mean()) ** 2))
    return {
        "n": int(len(y_true)),
        "rmse_C": float(np.sqrt(np.mean((y_true - y_pred) ** 2))),
        "mae_C": float(abs_err.mean()),
        "r2": float(1.0 - ss_res / ss_tot) if ss_tot > 0 else float("nan"),
        "max_abs_err_C": float(abs_err.max()) if abs_err.size else float("nan"),
        "p95_abs_err_C": float(np.percentile(abs_err, 95)) if abs_err.size else float("nan"),
    }


def per_temp_mean_pred(y_true_frames, y_pred_frames):
    y_true_frames = np.asarray(y_true_frames, float)
    y_pred_frames = np.asarray(y_pred_frames, float)
    uniq = np.array(sorted(np.unique(y_true_frames)))
    means = [float(np.mean(y_pred_frames[y_true_frames == t])) if np.any(y_true_frames == t)
             else float("nan") for t in uniq]
    return uniq, np.asarray(means)


# ---------------------------------------------------------------------------
# Degree selection + training
# ---------------------------------------------------------------------------

def choose_degree_by_groupcv(X, y, groups, degrees: Sequence[int],
                             cv_splits: int, epsilon: float, alpha: float, *,
                             device="cuda") -> int:
    """(``temperature_color_model.py:344-369``) with our Huber trainer on
    ``device``."""
    X = np.asarray(X, float)
    y = np.asarray(y, float)
    groups = np.asarray(groups)
    uniq = np.unique(groups)
    n_splits = int(min(cv_splits, len(uniq)))
    if n_splits < 2:
        return int(degrees[0])
    best_deg, best_rmse = None, None
    for deg in degrees:
        rmses = []
        for tr, te in groupkfold.group_kfold_split(X, y, groups, n_splits):
            m = fit_huber_poly(X[tr], y[tr], degree=int(deg), epsilon=epsilon, alpha=alpha,
                               device=device)
            pred = m.predict(X[te])
            rmses.append(float(np.sqrt(np.mean((y[te] - pred) ** 2))))
        mean_rmse = float(np.mean(rmses))
        if best_rmse is None or mean_rmse < best_rmse:
            best_rmse, best_deg = mean_rmse, int(deg)
    return int(best_deg)


def equation_string(weights: TempModelWeights, precision: int = 8) -> str:
    """Polynomial equation text matching the reference's formatting
    (``temperature_color_model.py:293-327``)."""
    names = list(weights.feature_names)
    terms = []
    for p in range(weights.powers.shape[0]):
        exps = weights.powers[p]
        if exps.sum() == 0:
            terms.append("1")
            continue
        parts = []
        for f, e in enumerate(exps):
            if e == 0:
                continue
            parts.append(names[f] if e == 1 else f"{names[f]}^{e}")
        terms.append("*".join(parts))

    parts = []
    if abs(weights.intercept) > 1e-12:
        parts.append(f"{weights.intercept:.{precision}g}")
    for c, term in zip(weights.coef, terms):
        if abs(c) < 1e-12:
            continue
        parts.append(f"({c:.{precision}g})*{term}")
    if not parts:
        return "T = 0  (all coefficients ~0)"
    eq = " + ".join(parts).replace("+ -", "- ")
    wrapped, cur = [], ""
    for tok in eq.split(" + "):
        if len(cur) + len(tok) + 3 > 120:
            if cur:
                wrapped.append(cur)
            cur = tok
        else:
            cur = tok if not cur else cur + " + " + tok
    if cur:
        wrapped.append(cur)
    return "T =\n  " + "\n  ".join(wrapped)


def pipeline_to_weights(p: HuberPolyPipeline, name: str,
                        feature_names: Tuple[str, ...],
                        iso: Optional[Tuple[np.ndarray, np.ndarray]] = None) -> TempModelWeights:
    return TempModelWeights(
        name=name,
        feature_names=tuple(feature_names),
        scaler_mean=p.scaler_mean,
        scaler_scale=p.scaler_scale,
        powers=p.powers.astype(np.int32),
        coef=p.fit_.coef,
        intercept=p.fit_.intercept,
        poly_degree=p.degree,
        iso_x=None if iso is None else iso[0],
        iso_y=None if iso is None else iso[1],
    )


def export_joblib_bundle(path: str, weights: TempModelWeights,
                         fit_temp_range, extra: Optional[Dict] = None) -> None:
    """Write a sklearn-pipeline joblib bundle built from our fitted weights,
    preserving the reference artifact contract
    (``temperature_color_model.py:915-955``).  Returns without writing where
    sklearn or joblib is missing, as the JAX trainer's does: a host file
    the .npz export already covers."""
    try:
        import joblib
        from sklearn.linear_model import HuberRegressor
        from sklearn.pipeline import make_pipeline
        from sklearn.preprocessing import PolynomialFeatures, StandardScaler
        from sklearn.isotonic import IsotonicRegression
    except Exception:
        return

    nf = len(weights.feature_names)
    sc = StandardScaler()
    sc.mean_ = np.asarray(weights.scaler_mean, float)
    sc.scale_ = np.asarray(weights.scaler_scale, float)
    sc.var_ = sc.scale_ ** 2
    sc.n_features_in_ = nf
    sc.n_samples_seen_ = 1

    pf = PolynomialFeatures(degree=weights.poly_degree, include_bias=True)
    pf.fit(np.zeros((1, nf)))

    hub = HuberRegressor()
    hub.coef_ = np.asarray(weights.coef, float)
    hub.intercept_ = float(weights.intercept)
    hub.scale_ = 1.0
    hub.n_features_in_ = pf.n_output_features_
    hub.outliers_ = np.zeros(1, dtype=bool)

    pipe = make_pipeline(sc, pf, hub)

    iso = None
    if weights.iso_x is not None:
        iso = IsotonicRegression(out_of_bounds="clip")
        iso.fit(weights.iso_x, weights.iso_y)

    bundle = {
        "model": pipe,
        "use_features": tuple(weights.feature_names),
        "poly_degree": int(weights.poly_degree),
        "regressor": "HuberRegressor",
        "scaler": "StandardScaler",
        "fit_temp_range": fit_temp_range,
    }
    if iso is not None:
        bundle["isotonic_calibrator"] = iso
    if extra:
        bundle.update(extra)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    joblib.dump(bundle, path)
