"""Trainer diagnostic-plot exports (the JAX package's ``trainers/plots.py``,
copied: host figures and CSVs).

Reproduces the reference trainers' figure/CSV artifact sets (same filenames,
same content structure) so a calibration run leaves the full inspection
trail:

- height_to_force: ``volume_by_force_boxplot.png`` + ``force_vs_volume_fit.png``
  (``height_to_force.py:487-532``)
- phase_to_height: ``calibration_plot.png`` (``phase_to_height.py:1548-1571``)
- temperature color: ``00_roi_overlay.png`` … ``08_global_mae_vs_T.png``
  (``temperature_color_model.py:449-643, 778-962``)
- temperature black: ``00…06`` gray-feature variants
  (``temperature_black_model.py:495-657``)
- pretest: ``Figure_1_pretest_<name>.png`` (``pretest_25to30.py:169-190``)

All figures render on the Agg backend; matplotlib is imported lazily so the
hot inference paths never pay for it.
"""
from __future__ import annotations

import csv
import os
from typing import Callable, Optional, Sequence

import numpy as np

# Reference figure constants (temperature_color_model.py:35-109)
FIG_W, FIG_H = 12, 12 / 2.8
COLOR_HEAT = "#fe8920"
COLOR_COOL = "#1f77b5"
COLOR_IDEAL = "#d72729"


def _plt():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def _moving_average(y: np.ndarray, window: int) -> np.ndarray:
    if window <= 1 or y.size < 2:
        return y
    k = min(int(window), y.size)
    kernel = np.ones(k) / k
    pad = k // 2
    ypad = np.pad(y, pad, mode="edge")
    out = np.convolve(ypad, kernel, mode="same")[pad:pad + y.size]
    return out


def forward_trend(T_frames, feat_frames, stat: str = "median",
                  smooth_window: int = 3, n_interp: int = 400):
    """Per-temperature median trend, smoothed and interpolated
    (``temperature_color_model.py:388-414``)."""
    T = np.asarray(T_frames, float)
    f = np.asarray(feat_frames, float)
    uniq = np.array(sorted(np.unique(T)), float)
    ys = np.array([np.median(f[T == t]) if stat != "mean" else np.mean(f[T == t])
                   for t in uniq])
    ok = np.isfinite(uniq) & np.isfinite(ys)
    uniq, ys = uniq[ok], ys[ok]
    if uniq.size < 2:
        return np.array([]), np.array([])
    ys = _moving_average(ys, smooth_window)
    xg = np.linspace(uniq.min(), uniq.max(), n_interp)
    return xg, np.interp(xg, uniq, ys)


def per_temp_stats(T_frames, feat_frames):
    T = np.asarray(T_frames, float)
    f = np.asarray(feat_frames, float)
    uniq = np.array(sorted(np.unique(T)), float)
    means = np.array([np.mean(f[T == t]) for t in uniq])
    stds = np.array([np.std(f[T == t]) for t in uniq])
    return uniq, means, stds


# ---------------------------------------------------------------------------
# Force trainers
# ---------------------------------------------------------------------------

def save_h2f_plots(out_dir: str, rows: Sequence[dict],
                   predict: Callable[[np.ndarray], np.ndarray],
                   force_levels: Sequence[float]) -> None:
    """Boxplot of volume per force level + fitted F(V) curve
    (``height_to_force.py:487-532``)."""
    plt = _plt()
    V = np.array([float(r["volume_cm3"]) for r in rows])
    F = np.array([float(r["force_N"]) for r in rows])

    vols_by_force = [[float(r["volume_cm3"]) for r in rows
                      if abs(float(r["force_N"]) - ff) < 1e-12]
                     for ff in force_levels]

    fig1, ax1 = plt.subplots(figsize=(8, 5))
    ax1.boxplot(vols_by_force, showfliers=True)
    ax1.set_xticks(range(1, len(force_levels) + 1))
    ax1.set_xticklabels([str(f) for f in force_levels])
    ax1.set_xlabel("Force (N)")
    ax1.set_ylabel("Integrated volume (cm³)")
    ax1.set_title("Indentation Volume Across Force Levels (5 images per force)")
    rng = np.random.default_rng(0)
    for k, vols in enumerate(vols_by_force, start=1):
        if vols:
            xj = k + (rng.random(len(vols)) - 0.5) * 0.18
            ax1.scatter(xj, vols, s=18)
    fig1.tight_layout()
    fig1.savefig(os.path.join(out_dir, "volume_by_force_boxplot.png"), dpi=200)
    plt.close(fig1)

    fig2, ax2 = plt.subplots(figsize=(8, 5))
    ax2.scatter(V, F, s=18)
    vmin, vmax = float(V.min()), float(V.max())
    xs = np.linspace(max(0.0, vmin * 0.95), vmax * 1.05, 400)
    ax2.plot(xs, np.asarray(predict(xs)))
    ax2.set_xlabel("Integrated volume (cm³)")
    ax2.set_ylabel("Force (N)")
    ax2.set_title("Force-Volume Calibration Curve")
    fig2.tight_layout()
    fig2.savefig(os.path.join(out_dir, "force_vs_volume_fit.png"), dpi=200)
    plt.close(fig2)


def save_p2h_plot(out_dir: str, x: np.ndarray, y: np.ndarray,
                  predict: Callable[[np.ndarray], np.ndarray],
                  use_negated: bool = True) -> None:
    """Unitless-height → mm calibration curve (``phase_to_height.py:1548-1571``)."""
    plt = _plt()
    fig = plt.figure(figsize=(7.2, 4.6))
    plt.scatter(x, y, color="C0")
    plt.scatter([0.0], [0.0], color="C0")
    xs = np.linspace(0.0, float(np.max(x)), 400)
    plt.xlim(left=0.0)
    plt.ylim(bottom=0.0)
    plt.plot(xs, np.asarray(predict(xs)))
    plt.xlabel("x = -min_height_unitless" if use_negated else "x = min_height_unitless")
    plt.ylabel("depth (mm)")
    plt.title("Calibration from unitless height to mm deformation distance")
    plt.tight_layout()
    fig.savefig(os.path.join(out_dir, "calibration_plot.png"), dpi=200)
    plt.close(fig)


# ---------------------------------------------------------------------------
# Temperature trainers
# ---------------------------------------------------------------------------

def save_annulus_roi_overlay(out_path: str, image_bgr: np.ndarray,
                             mask: np.ndarray, inner_pts, outer_pts) -> None:
    """First calibration frame with the annulus ROI and its defining points
    (``temperature_color_model.py:176-205``)."""
    plt = _plt()
    from vistaf_torch.ops.geometry import circle_from_3_points_exact

    rgb = image_bgr[..., ::-1]
    theta = np.linspace(0, 2 * np.pi, 500)
    fig = plt.figure(figsize=(FIG_W, FIG_H))
    plt.imshow(rgb)
    plt.imshow(mask.astype(float), alpha=0.35)
    for pts in (inner_pts, outer_pts):
        cx, cy, r = circle_from_3_points_exact(*pts)
        plt.plot(cx + r * np.cos(theta), cy + r * np.sin(theta), linewidth=2.5)
    xs = [p[0] for p in inner_pts + outer_pts]
    ys = [p[1] for p in inner_pts + outer_pts]
    plt.scatter(xs, ys, s=20)
    plt.title("Annulus ROI overlay (outer circle minus inner circle)")
    plt.axis("off")
    plt.tight_layout()
    plt.savefig(out_path, dpi=150, bbox_inches="tight")
    plt.close(fig)


def plot_feat_vs_T_run(out_path: str, title: str, ylabel: str, color: str,
                       T_frames, feat_frames) -> None:
    """Single-run feature-vs-T with mean±std and forward trend
    (``temperature_color_model.py:449-483``)."""
    plt = _plt()
    T = np.asarray(T_frames, float)
    f = np.asarray(feat_frames, float)
    uniq, means, stds = per_temp_stats(T, f)
    fig = plt.figure(figsize=(FIG_W, FIG_H))
    rng = np.random.default_rng(0)
    plt.scatter(T + (rng.random(T.size) - 0.5) * 0.2, f, alpha=0.25, s=14,
                color=color, label="Measured frames")
    plt.errorbar(uniq, means, yerr=stds, fmt="o", capsize=3, color=color,
                 markersize=5, label="Measured mean ± std")
    xg, yg = forward_trend(T, f)
    if xg.size:
        plt.plot(xg, yg, color=color, linewidth=2.0,
                 label="Trend (from measured frames)")
    plt.xlabel("Temperature [°C]")
    plt.ylabel(ylabel)
    plt.title(title)
    plt.grid(alpha=0.3)
    plt.legend()
    plt.tight_layout()
    plt.savefig(out_path, dpi=150, bbox_inches="tight")
    plt.close(fig)


def plot_hysteresis(out_path: str, title: str, ylabel: str,
                    y_heat, feat_heat, y_cool, feat_cool) -> None:
    """Heating-vs-cooling hysteresis (``temperature_color_model.py:485-522``)."""
    plt = _plt()
    fig = plt.figure(figsize=(FIG_W, FIG_H))
    for (T, f, color, fmt, label) in (
            (y_heat, feat_heat, COLOR_HEAT, "o", "Heating"),
            (y_cool, feat_cool, COLOR_COOL, "s", "Cooling")):
        uniq, means, stds = per_temp_stats(T, f)
        plt.errorbar(uniq, means, yerr=stds, fmt=fmt, capsize=3, color=color,
                     markersize=5, label=f"{label} (mean ± std)")
        xg, yg = forward_trend(T, f)
        if xg.size:
            plt.plot(xg, yg, linewidth=2.0, color=color, label=f"{label} trend")
    plt.xlabel("Temperature [°C]")
    plt.ylabel(ylabel)
    plt.title(title)
    plt.grid(alpha=0.3)
    plt.legend()
    plt.tight_layout()
    plt.savefig(out_path, dpi=150, bbox_inches="tight")
    plt.close(fig)


def plot_true_vs_pred(out_path: str, title: str,
                      y_heat_true, y_heat_pred, y_cool_true, y_cool_pred,
                      y_means_true=None, y_means_pred=None) -> None:
    """Measured-vs-predicted split scatter (``temperature_color_model.py:524-564``)."""
    plt = _plt()
    arrs = [np.asarray(a, float) for a in
            (y_heat_true, y_heat_pred, y_cool_true, y_cool_pred)]
    allv = np.concatenate(arrs)
    tmin, tmax = float(allv.min()), float(allv.max())
    fig = plt.figure(figsize=(FIG_W, FIG_H))
    plt.plot([tmin, tmax], [tmin, tmax], "--", linewidth=1.5,
             color=COLOR_IDEAL, label="Ideal (y=x)")
    plt.scatter(arrs[0], arrs[1], s=10, alpha=0.22, color=COLOR_HEAT,
                label="Heating frames")
    plt.scatter(arrs[2], arrs[3], s=10, alpha=0.22, color=COLOR_COOL,
                label="Cooling frames")
    if y_means_true is not None and y_means_pred is not None:
        plt.scatter(np.asarray(y_means_true, float), np.asarray(y_means_pred, float),
                    s=28, alpha=0.95, color=COLOR_IDEAL,
                    label="Per-temp mean prediction")
    plt.xlabel("Measured Temperature [°C]")
    plt.ylabel("Predicted Temperature [°C]")
    plt.title(title)
    plt.grid(alpha=0.3)
    plt.legend()
    plt.tight_layout()
    plt.savefig(out_path, dpi=150, bbox_inches="tight")
    plt.close(fig)


def plot_feat_vs_T_all(out_path: str, title: str, ylabel: str,
                       y_heat, feat_heat, y_cool, feat_cool) -> None:
    """Merged heating+cooling feature-vs-T with global mean±std + trend
    (``temperature_color_model.py:566-604``)."""
    plt = _plt()
    yh, fh = np.asarray(y_heat, float), np.asarray(feat_heat, float)
    yc, fc = np.asarray(y_cool, float), np.asarray(feat_cool, float)
    y_all = np.concatenate([yh, yc])
    f_all = np.concatenate([fh, fc])
    uniq, means, stds = per_temp_stats(y_all, f_all)
    fig = plt.figure(figsize=(FIG_W, FIG_H))
    rng = np.random.default_rng(0)
    plt.scatter(yh + (rng.random(yh.size) - 0.5) * 0.2, fh, alpha=0.18, s=14,
                color=COLOR_HEAT, label="Measured frames (heating)")
    plt.scatter(yc + (rng.random(yc.size) - 0.5) * 0.2, fc, alpha=0.18, s=14,
                color=COLOR_COOL, label="Measured frames (cooling)")
    plt.errorbar(uniq, means, yerr=stds, fmt="o", capsize=3, color=COLOR_IDEAL,
                 markersize=5, label="Measured mean ± std (all data)")
    xg, yg = forward_trend(y_all, f_all)
    if xg.size:
        plt.plot(xg, yg, linewidth=2.0, color=COLOR_IDEAL,
                 label="Trend (from measured frames)")
    plt.xlabel("Temperature [°C]")
    plt.ylabel(ylabel)
    plt.title(title)
    plt.grid(alpha=0.3)
    plt.legend()
    plt.tight_layout()
    plt.savefig(out_path, dpi=150, bbox_inches="tight")
    plt.close(fig)


def save_per_temp_error_csv(out_csv: str, y_true_frames, y_pred_frames,
                            label: str) -> None:
    """Per-temperature error table (``temperature_color_model.py:605-628``)."""
    yt = np.asarray(y_true_frames, float)
    yp = np.asarray(y_pred_frames, float)
    rows = []
    for t in sorted(np.unique(yt)):
        err = yp[yt == t] - t
        rows.append({
            "label": label, "T_true": float(t),
            "n_frames": int(np.count_nonzero(yt == t)),
            "mean_pred": float(np.mean(yp[yt == t])),
            "mean_err": float(np.mean(err)),
            "mae": float(np.mean(np.abs(err))),
            "rmse": float(np.sqrt(np.mean(err ** 2))),
            "max_abs_err": float(np.max(np.abs(err))),
        })
    with open(out_csv, "w", newline="", encoding="utf-8") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
        w.writeheader()
        w.writerows(rows)


def plot_per_temp_mae(out_path: str, y_true_frames, y_pred_frames,
                      title: str) -> None:
    """MAE-vs-temperature line (``temperature_color_model.py:630-643``)."""
    plt = _plt()
    yt = np.asarray(y_true_frames, float)
    yp = np.asarray(y_pred_frames, float)
    uniq = np.array(sorted(np.unique(yt)), float)
    maes = [float(np.mean(np.abs(yp[yt == t] - t))) for t in uniq]
    fig = plt.figure(figsize=(FIG_W, FIG_H))
    plt.plot(uniq, maes, marker="o", linewidth=2.0, markersize=5)
    plt.xlabel("Temperature [°C]")
    plt.ylabel("MAE [°C]")
    plt.title(title)
    plt.grid(alpha=0.3)
    plt.tight_layout()
    plt.savefig(out_path, dpi=150, bbox_inches="tight")
    plt.close(fig)


# ---------------------------------------------------------------------------
# Pretest
# ---------------------------------------------------------------------------

def save_pretest_figure(out_path: str, times: np.ndarray, values: np.ndarray,
                        stabilization_time: Optional[float],
                        label: str) -> None:
    """Pre-test ROI mean-L evolution with the stabilization marker
    (``pretest_25to30.py:169-190``; the reference shows the window
    interactively — here it is saved with the committed figures' naming)."""
    plt = _plt()
    times = np.asarray(times, float)
    values = np.asarray(values, float)
    fig = plt.figure(figsize=(8, 4))
    plt.plot(times, values, "o-", label="ROI mean L (LAB)")
    plt.xlabel("Time [s]")
    plt.ylabel("Mean L (LAB) in ROI")
    plt.title(f"Pre-test evolution: {label}")
    final_val = values[-5:].mean() if values.size >= 5 else values[-1]
    plt.axhline(final_val, color="gray", linestyle="--", label="Final mean")
    if stabilization_time is not None:
        plt.axvline(stabilization_time, color="red", linestyle="--",
                    label="Stabilization time")
        plt.text(stabilization_time, final_val,
                 f"  t ≈ {stabilization_time / 60:.1f} min",
                 color="red", va="bottom")
    plt.grid(True, alpha=0.3)
    plt.legend()
    plt.tight_layout()
    fig.savefig(out_path, dpi=150)
    plt.close(fig)
