"""Scalar model fitting: closed forms, grid searches, bounded Gauss-Newton
(the JAX package's ``calib/fitting.py``, copied: numpy only).

Replaces the reference's scipy.optimize.curve_fit calls
(``height_to_force.py:139-237``, ``phase_to_height.py:1280-1332``) with a
self-contained bounded Levenberg–Marquardt (projected, multi-start) plus the
reference's own closed-form/grid families (``phase_to_height.py:1082-1262``).
Fitting is tiny host-side numerics (<=95 points, <=3 params) — NumPy, not a
device workload.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np


# ---------------------------------------------------------------------------
# Metrics (height_to_force.py:88-100)
# ---------------------------------------------------------------------------

def r2_score(y_true, y_pred) -> float:
    y_true = np.asarray(y_true, float)
    y_pred = np.asarray(y_pred, float)
    ss_res = float(np.sum((y_true - y_pred) ** 2))
    ss_tot = float(np.sum((y_true - np.mean(y_true)) ** 2))
    if ss_tot <= 1e-18:
        return float("nan")
    return float(1.0 - ss_res / ss_tot)


def rmse(y_true, y_pred) -> float:
    y_true = np.asarray(y_true, float)
    y_pred = np.asarray(y_pred, float)
    return float(np.sqrt(np.mean((y_true - y_pred) ** 2)))


# ---------------------------------------------------------------------------
# Bounded Levenberg–Marquardt (curve_fit replacement)
# ---------------------------------------------------------------------------

def lm_fit(f: Callable, x: np.ndarray, y: np.ndarray, p0: Sequence[float],
           bounds: Tuple[Sequence[float], Sequence[float]],
           max_iter: int = 400, tol: float = 1e-12,
           n_multistart: int = 8, seed: int = 0) -> Optional[np.ndarray]:
    """Minimize ||f(x, *p) - y||^2 subject to box bounds.

    Projected Levenberg–Marquardt with finite-difference Jacobian and random
    multi-starts inside the bounds (replaces scipy's trf-based curve_fit for
    the 2-3 parameter exponential families used here).
    """
    x = np.asarray(x, float)
    y = np.asarray(y, float)
    lo = np.asarray(bounds[0], float)
    hi = np.asarray(bounds[1], float)
    p0 = np.clip(np.asarray(p0, float), lo, hi)
    n_p = len(p0)
    rng = np.random.default_rng(seed)

    def residual(p):
        with np.errstate(over="ignore", invalid="ignore"):
            r = f(x, *p) - y
        r = np.where(np.isfinite(r), r, 1e150)
        return r

    def sse(p):
        r = residual(p)
        return float(np.dot(r, r))

    def jac(p):
        J = np.zeros((len(x), n_p))
        r0 = residual(p)
        for j in range(n_p):
            h = max(1e-8, 1e-8 * abs(p[j]))
            pj = p.copy()
            pj[j] = min(p[j] + h, hi[j]) if p[j] + h <= hi[j] else max(p[j] - h, lo[j])
            step = pj[j] - p[j]
            if step == 0.0:
                continue
            J[:, j] = (residual(pj) - r0) / step
        return J, r0

    def solve_from(p):
        p = np.clip(p.astype(float), lo, hi)
        lam = 1e-3
        best_sse = sse(p)
        for _ in range(max_iter):
            J, r = jac(p)
            JtJ = J.T @ J
            g = J.T @ r
            if not np.all(np.isfinite(JtJ)) or not np.all(np.isfinite(g)):
                break
            improved = False
            for _ in range(20):
                try:
                    dp = np.linalg.solve(JtJ + lam * np.diag(np.maximum(np.diag(JtJ), 1e-12)), -g)
                except np.linalg.LinAlgError:
                    lam *= 10
                    continue
                p_new = np.clip(p + dp, lo, hi)
                s_new = sse(p_new)
                if s_new < best_sse:
                    rel = (best_sse - s_new) / max(best_sse, 1e-300)
                    p = p_new
                    best_sse = s_new
                    lam = max(lam * 0.3, 1e-12)
                    improved = True
                    if rel < tol:
                        return p, best_sse
                    break
                lam *= 10
                if lam > 1e12:
                    break
            if not improved:
                break
        return p, best_sse

    starts = [p0]
    span_lo = np.where(np.isfinite(lo), lo, -1.0)
    span_hi = np.where(np.isfinite(hi), hi, np.abs(p0) * 10 + 10.0)
    for _ in range(n_multistart - 1):
        starts.append(span_lo + rng.random(n_p) * (span_hi - span_lo))

    best = None
    best_sse = np.inf
    for s in starts:
        p, ss = solve_from(np.asarray(s, float))
        if ss < best_sse:
            best, best_sse = p, ss
    return best


# ---------------------------------------------------------------------------
# Model families f(x; params)
# ---------------------------------------------------------------------------

def _f_sat_exp(x, a, b):
    return a * (1.0 - np.exp(-b * np.maximum(x, 0.0)))


def _f_growth(x, a, b):
    return a * (np.exp(b * np.maximum(x, 0.0)) - 1.0)


def _f_hinge_sat(x, a, b, c):
    x = np.asarray(x, float)
    return a * ((1.0 - np.exp(-b * np.maximum(x - c, 0.0)))
                - (1.0 - np.exp(-b * np.maximum(0.0 - c, 0.0))))


# ---------------------------------------------------------------------------
# Per-family fitters, mirroring the reference's parameterizations
# ---------------------------------------------------------------------------

def fit_linear0(x, y) -> Optional[Dict]:
    x = np.asarray(x, float); y = np.asarray(y, float)
    denom = float(np.sum(x * x))
    if denom <= 1e-18:
        return None
    a = float(np.sum(x * y) / denom)
    yhat = a * x
    return {"type": "linear0", "params": {"a": a},
            "equation": f"F = {a:.6g} * V", "yhat": yhat, "k": 1}


def fit_linear(x, y) -> Optional[Dict]:
    x = np.asarray(x, float); y = np.asarray(y, float)
    A = np.column_stack([x, np.ones_like(x)])
    coef, *_ = np.linalg.lstsq(A, y, rcond=None)
    a, b = float(coef[0]), float(coef[1])
    return {"type": "linear", "params": {"a": a, "b": b},
            "equation": f"F = {a:.6g} * V + {b:.6g}", "yhat": a * x + b, "k": 2}


def fit_poly2(x, y) -> Optional[Dict]:
    x = np.asarray(x, float); y = np.asarray(y, float)
    if len(x) < 3:
        return None
    c2, c1, c0 = [float(v) for v in np.polyfit(x, y, deg=2)]
    yhat = c2 * x * x + c1 * x + c0
    return {"type": "poly2", "params": {"c2": c2, "c1": c1, "c0": c0},
            "equation": f"F = {c2:.6g} * V^2 + {c1:.6g} * V + {c0:.6g}",
            "yhat": yhat, "k": 3}


def fit_exp(x, y) -> Optional[Dict]:
    """log-linear fit of y = a*exp(b x); requires y > 0
    (``phase_to_height.py:1111-1124``)."""
    x = np.asarray(x, float); y = np.asarray(y, float)
    if np.any(y <= 0):
        return None
    A = np.column_stack([x, np.ones_like(x)])
    coef, *_ = np.linalg.lstsq(A, np.log(y), rcond=None)
    b, lna = float(coef[0]), float(coef[1])
    a = float(np.exp(lna))
    yhat = a * np.exp(b * x)
    return {"type": "exp", "params": {"a": a, "b": b},
            "equation": f"y = {a:.6g} * exp({b:.6g} x)", "yhat": yhat, "k": 2}


def fit_power(x, y) -> Optional[Dict]:
    x = np.asarray(x, float); y = np.asarray(y, float)
    if np.any(x <= 0) or np.any(y <= 0):
        return None
    A = np.column_stack([np.log(x), np.ones_like(x)])
    coef, *_ = np.linalg.lstsq(A, np.log(y), rcond=None)
    b, lna = float(coef[0]), float(coef[1])
    a = float(np.exp(lna))
    yhat = a * x ** b
    return {"type": "power", "params": {"a": a, "b": b},
            "equation": f"y = {a:.6g} * x^{b:.6g}", "yhat": yhat, "k": 2}


def fit_sat_exp_grid(x, y) -> Optional[Dict]:
    """b on a log grid, a closed-form per b (``phase_to_height.py:1143-1191``)."""
    x = np.asarray(x, float); y = np.asarray(y, float)
    if np.any(x < 0) or np.any(y < 0):
        return None
    x_max = float(np.max(x))
    if x_max <= 1e-12:
        return None
    b_grid = np.logspace(-3, 3, 400) / max(1e-6, x_max)
    best = None
    for b in b_grid:
        u = 1.0 - np.exp(-b * x)
        denom = float(np.sum(u * u))
        if denom <= 1e-12:
            continue
        a = float(np.sum(u * y) / denom)
        sse = float(np.sum((y - a * u) ** 2))
        if best is None or sse < best[2]:
            best = (a, float(b), sse)
    if best is None:
        return None
    a, b, _ = best
    yhat = _f_sat_exp(x, a, b)
    return {"type": "sat_exp", "params": {"a": a, "b": b},
            "equation": f"y = {a:.6g} * (1 - exp(-{b:.6g} x))", "yhat": yhat, "k": 2}


def fit_sat_exp_lm(x, y) -> Optional[Dict]:
    """curve_fit-style sat_exp (``height_to_force.py:181-196``)."""
    x = np.asarray(x, float); y = np.asarray(y, float)
    p0 = [max(np.max(y), 1e-6), 1.0]
    p = lm_fit(_f_sat_exp, x, y, p0, ([0.0, 0.0], [np.inf, np.inf]))
    if p is None:
        return None
    a, b = float(p[0]), float(p[1])
    yhat = _f_sat_exp(x, a, b)
    return {"type": "sat_exp", "params": {"a": a, "b": b},
            "equation": f"F = {a:.6g} * (1 - exp(-{b:.6g} * V))", "yhat": yhat, "k": 2}


def fit_sat_exp_shift_grid(x, y,
                           b_log10=(-4.0, 4.0), b_steps=2500,
                           x0_pads=(0.6, 0.2), x0_steps=500) -> Optional[Dict]:
    """Origin-constrained 2-D grid search (``phase_to_height.py:1194-1262``)."""
    x = np.asarray(x, float); y = np.asarray(y, float)
    if np.any(x < 0) or np.any(y < 0) or len(x) < 2:
        return None
    x_min = float(np.min(x)); x_max = float(np.max(x))
    span = max(1e-12, x_max - x_min)
    b_grid = (10.0 ** np.linspace(b_log10[0], b_log10[1], int(b_steps))) / span
    x0_grid = np.linspace(x_min - x0_pads[0] * span, x_min + x0_pads[1] * span, int(x0_steps))
    best = None
    # vectorized over b for each x0
    for x0 in x0_grid:
        xeff = np.maximum(x - x0, 0.0)
        g = 1.0 - np.exp(-np.outer(b_grid, xeff))        # (B, N)
        g0 = 1.0 - np.exp(-b_grid * max(0.0 - x0, 0.0))  # (B,)
        u = g - g0[:, None]
        denom = np.sum(u * u, axis=1)
        ok = denom > 1e-12
        a = np.where(ok, (u @ y) / np.where(ok, denom, 1.0), -1.0)
        valid = ok & (a >= 0)
        if not np.any(valid):
            continue
        sse = np.sum((y[None, :] - a[:, None] * u) ** 2, axis=1)
        sse = np.where(valid, sse, np.inf)
        i = int(np.argmin(sse))
        if best is None or sse[i] < best[3]:
            best = (float(a[i]), float(b_grid[i]), float(x0), float(sse[i]))
    if best is None:
        return None
    a, b, x0, _ = best
    g = 1.0 - np.exp(-b * np.maximum(x - x0, 0.0))
    g0 = 1.0 - np.exp(-b * max(0.0 - x0, 0.0))
    yhat = a * (g - g0)
    eq = (f"y = {a:.6g} * ( (1 - exp(-{b:.6g}*max(x-{x0:.6g},0)))"
          f" - (1 - exp(-{b:.6g}*max(0-{x0:.6g},0))) )")
    return {"type": "sat_exp_shift", "params": {"a": a, "b": b, "x0": x0},
            "equation": eq, "yhat": yhat, "k": 3}


def fit_growth(x, y) -> Optional[Dict]:
    x = np.asarray(x, float); y = np.asarray(y, float)
    if np.any(x < 0) or np.any(y < 0):
        return None
    p0 = [max(np.max(y), 1e-6), 1.0]
    p = lm_fit(_f_growth, x, y, p0, ([0.0, 0.0], [np.inf, np.inf]))
    if p is None:
        return None
    a, b = float(p[0]), float(p[1])
    yhat = _f_growth(x, a, b)
    return {"type": "growth", "params": {"a": a, "b": b},
            "equation": f"y = {a:.6g} * (exp({b:.6g} x) - 1)", "yhat": yhat, "k": 2}


def fit_hinge_saturating(x, y) -> Optional[Dict]:
    x = np.asarray(x, float); y = np.asarray(y, float)
    if np.any(x < 0) or np.any(y < 0):
        return None
    xmax = float(np.max(x)) if len(x) else 1.0
    p0 = [max(np.max(y), 1e-6), 2.0, 0.2 * xmax]
    p = lm_fit(_f_hinge_sat, x, y, p0, ([0.0, 0.0, -0.5 * xmax], [np.inf, np.inf, 1.2 * xmax]))
    if p is None:
        return None
    a, b, c = float(p[0]), float(p[1]), float(p[2])
    # (a, c<0) is redundant: f(x; a, b, c) == f(x; a*e^{b c}, b, 0) exactly.
    # Canonicalize to the c=0 basin so fitted constants are comparable run
    # to run (and to the reference's curve_fit convention).
    if c < 0:
        a = a * float(np.exp(b * c))
        c = 0.0
    yhat = _f_hinge_sat(x, a, b, c)
    eq = (f"y = {a:.6g} * ((1-exp(-{b:.6g}*max(x-{c:.6g},0)))"
          f" - (1-exp(-{b:.6g}*max(0-{c:.6g},0))))")
    return {"type": "hinge_saturating", "params": {"a": a, "b": b, "c": c},
            "equation": eq, "yhat": yhat, "k": 3}


_FITTERS = {
    "linear0": fit_linear0,
    "linear": fit_linear,
    "poly2": fit_poly2,
    "exp": fit_exp,
    "power": fit_power,
    "sat_exp": fit_sat_exp_lm,
    "sat_exp_grid": fit_sat_exp_grid,
    "sat_exp_shift": fit_sat_exp_shift_grid,
    "growth": fit_growth,
    "hinge_saturating": fit_hinge_saturating,
}


def fit_model(x, y, name: str) -> Optional[Dict]:
    fitter = _FITTERS.get(name)
    if fitter is None:
        return None
    return fitter(x, y)


def fit_best_model(x, y, candidates: Sequence[str]) -> Tuple[Dict, List[Dict]]:
    """Fit every candidate, rank by RMSE (``height_to_force.py:257-278``)."""
    x = np.asarray(x, float)
    y = np.asarray(y, float)
    fitted = []
    for name in candidates:
        m = fit_model(x, y, name)
        if m is None:
            continue
        m["sse"] = float(np.sum((y - m["yhat"]) ** 2))
        m["rmse"] = rmse(y, m["yhat"])
        m["r2"] = r2_score(y, m["yhat"])
        fitted.append(m)
    if not fitted:
        raise RuntimeError("No model could be fit (check your data).")
    best = min(fitted, key=lambda d: d["rmse"])
    summary = [{"type": c["type"], "rmse": float(c["rmse"]), "r2": float(c["r2"]),
                "sse": float(c["sse"])}
               for c in sorted(fitted, key=lambda d: d["rmse"])]
    return best, summary
