"""Isotonic regression (PAVA) + monotone interpolation predictor (the JAX
package's ``calib/isotonic.py``, copied: host work on a few hundred points).

Replaces sklearn.IsotonicRegression(out_of_bounds="clip") used as a
prediction calibrator by the colored-TLC trainer
(``temperature_color_model.py:418-428``).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def pava(y: np.ndarray, w: np.ndarray) -> np.ndarray:
    """Pool-adjacent-violators on (y, weights), nondecreasing output."""
    n = len(y)
    sol = y.astype(np.float64).copy()
    wgt = w.astype(np.float64).copy()
    # block representation
    start = list(range(n))
    vals = list(sol)
    wts = list(wgt)
    out_start = []
    out_vals = []
    out_wts = []
    for i in range(n):
        cs, cv, cw = start[i], vals[i], wts[i]
        while out_vals and out_vals[-1] > cv:
            pv, pw = out_vals.pop(), out_wts.pop()
            cs = out_start.pop()
            cv = (pv * pw + cv * cw) / (pw + cw)
            cw = pw + cw
        out_start.append(cs)
        out_vals.append(cv)
        out_wts.append(cw)
    res = np.empty(n)
    bounds = out_start + [n]
    for b in range(len(out_vals)):
        res[bounds[b]:bounds[b + 1]] = out_vals[b]
    return res


def fit_isotonic(x: np.ndarray, y: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Fit y = iso(x), nondecreasing; returns (x_thresholds, y_thresholds)
    with duplicate-x groups averaged first (sklearn's 'secondary' method uses
    mean within ties) and interior-redundant points dropped."""
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    order = np.argsort(x, kind="stable")
    xs = x[order]
    ys = y[order]
    # aggregate duplicates
    ux, inv, counts = np.unique(xs, return_inverse=True, return_counts=True)
    sums = np.zeros(len(ux))
    np.add.at(sums, inv, ys)
    ymean = sums / counts
    w = counts.astype(np.float64)
    yfit = pava(ymean, w)
    return ux, yfit


def isotonic_predict(x_thr: np.ndarray, y_thr: np.ndarray, x) -> np.ndarray:
    """Linear interpolation with clipping out of bounds (sklearn
    out_of_bounds='clip')."""
    return np.interp(np.asarray(x, np.float64), x_thr, y_thr)
