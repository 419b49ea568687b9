"""Temperature model weights as plain numpy arrays (JAX ``calib/temp_weights.py``).

A fitted temperature model is StandardScaler -> PolynomialFeatures ->
HuberRegressor, optionally followed by an isotonic calibrator.  The JAX
package exports those fitted parameters once into ``TempModelWeights``;
the port keeps the same fields.  ``from_joblib`` reads a reference joblib
bundle (it needs joblib and sklearn, imported only there),
``load_reference_models`` the newest pair under a data root, and
``from_numpy`` carries a JAX export across.

Two evaluations: ``TempModelWeights.predict``, the unfused path of the
parity preset, in the JAX ``predict``'s order; and ``tables``, which packs
the model into the float32 tables that the fused per-pixel kernel and its
plain version read (``kernels/temp_kernel.py``), with the JAX Pallas
kernel's roundings: every constant is the float32 rounding of a float64
value formed on the host.
"""
from __future__ import annotations

import dataclasses
import functools
import glob
import os
from itertools import combinations_with_replacement
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from plainref.config import TEMP_COLOR_MODEL_GLOB, TEMP_WIDE_MODEL_GLOB

# np.spacing(np.finfo(np.float32).eps): jnp.interp's test for a zero-width
# knot interval
_INTERP_EPS = float(np.spacing(np.finfo(np.float32).eps))


class PolyTables(NamedTuple):
    """One model as the fused kernel evaluates it.

    ``powers``/``coef`` keep only the terms whose float64 coefficient is not
    0 (the JAX kernel skips the others), in table order.  Isotonic segments
    (x0, y0, x1 - x0, y1 - y0) drop those with x1 <= x0; ``iso_y0`` is
    the value below the first knot (or of a NaN prediction), None without a
    calibrator."""
    mean: np.ndarray        # (F,) float32
    scale: np.ndarray       # (F,) float32
    powers: np.ndarray      # (P', F) uint8
    coef: np.ndarray        # (P',) float32
    intercept: np.float32
    iso_seg: np.ndarray     # (S, 4) float32
    iso_y0: Optional[np.float32]


@dataclasses.dataclass(frozen=True)
class TempModelWeights:
    """Plain-array export of one temperature regression pipeline."""
    name: str
    feature_names: Tuple[str, ...]       # e.g. ("L","a","b") or ("L","a","b","gray")
    scaler_mean: np.ndarray              # (F,)
    scaler_scale: np.ndarray             # (F,)
    powers: np.ndarray                   # (P, F) int exponent table
    coef: np.ndarray                     # (P,)
    intercept: float
    poly_degree: int
    iso_x: Optional[np.ndarray] = None   # isotonic thresholds (increasing)
    iso_y: Optional[np.ndarray] = None

    @functools.cached_property
    def tables(self) -> PolyTables:
        mean = np.asarray(self.scaler_mean, np.float64)
        scale = np.asarray(self.scaler_scale, np.float64)
        powers = np.asarray(self.powers)
        coef = np.asarray(self.coef, np.float64).ravel()
        n_feat = len(self.feature_names)
        if mean.shape != (n_feat,) or scale.shape != (n_feat,) \
                or powers.ndim != 2 or powers.shape != (coef.size, n_feat):
            raise ValueError(f"{self.name}: inconsistent shapes mean {mean.shape}, "
                             f"scale {scale.shape}, powers {powers.shape}, "
                             f"coef {coef.shape} for {n_feat} features")
        if powers.min(initial=0) < 0 or powers.max(initial=0) > 255:
            raise ValueError(f"{self.name}: exponents must lie in [0, 255]")
        keep = coef != 0.0
        segs = np.zeros((0, 4), np.float32)
        y_first = None
        if self.iso_x is not None:
            x = np.asarray(self.iso_x, np.float64)
            y = np.asarray(self.iso_y, np.float64)
            if x.shape != y.shape or x.ndim != 1 or x.size == 0:
                raise ValueError(f"{self.name}: iso_x {x.shape} and iso_y {y.shape} "
                                 "must be equal non-empty vectors")
            ok = ~(x[1:] <= x[:-1])
            segs = np.stack([x[:-1], y[:-1], x[1:] - x[:-1], y[1:] - y[:-1]],
                            axis=1)[ok].astype(np.float32)
            y_first = np.float32(y[0])
        return PolyTables(mean.astype(np.float32), scale.astype(np.float32),
                          powers[keep].astype(np.uint8), coef[keep].astype(np.float32),
                          np.float32(self.intercept), segs, y_first)

    @functools.cached_property
    def _on_device(self) -> Dict[torch.device, Tuple[torch.Tensor, torch.Tensor]]:
        return {}

    def predict(self, X: torch.Tensor) -> torch.Tensor:
        """Evaluate on features ``X`` (..., F) -> (...,) float32, in the JAX
        ``predict``'s order: the scaled features (X - mean) * (1 / scale),
        as XLA compiles the division by a constant; each term's features in
        feature order, each a product of its exponent's copies; then
        ``out + c * term`` term by term from the intercept, skipping zero
        coefficients; then the isotonic calibrator as ``jnp.interp``."""
        mean = np.asarray(self.scaler_mean, np.float32)
        rscale = np.float32(1.0) / np.asarray(self.scaler_scale, np.float32)
        X = X.to(torch.float32)
        xs = [(X[..., f] - float(mean[f])) * float(rscale[f]) for f in range(X.shape[-1])]
        out = torch.full(X.shape[:-1], float(np.float32(self.intercept)),
                         dtype=torch.float32, device=X.device)
        powers = np.asarray(self.powers)
        for c, row in zip(np.asarray(self.coef, np.float64).ravel(), powers):
            if c == 0.0:
                continue
            term = None
            for f, e in enumerate(row):
                if e == 0:
                    continue
                contrib = xs[f]
                for _ in range(int(e) - 1):
                    contrib = contrib * xs[f]
                term = contrib if term is None else term * contrib
            out = out + float(c) if term is None else out + float(c) * term
        if self.iso_x is None:
            return out
        if X.device not in self._on_device:
            self._on_device[X.device] = tuple(
                torch.as_tensor(np.asarray(v, np.float32), device=X.device)
                for v in (self.iso_x, self.iso_y))
        return interp(out, *self._on_device[X.device])

    # ------------------------------------------------------------------
    def save_npz(self, path: str) -> None:
        d = {
            "feature_names": np.array(self.feature_names),
            "scaler_mean": self.scaler_mean,
            "scaler_scale": self.scaler_scale,
            "powers": self.powers,
            "coef": self.coef,
            "intercept": np.float64(self.intercept),
            "poly_degree": np.int32(self.poly_degree),
            "name": np.array(self.name),
        }
        if self.iso_x is not None:
            d["iso_x"] = self.iso_x
            d["iso_y"] = self.iso_y
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        np.savez(path, **d)

    @staticmethod
    def load_npz(path: str) -> "TempModelWeights":
        z = np.load(path, allow_pickle=False)
        return TempModelWeights(
            name=str(z["name"]),
            feature_names=tuple(str(s) for s in z["feature_names"]),
            scaler_mean=z["scaler_mean"].astype(np.float64),
            scaler_scale=z["scaler_scale"].astype(np.float64),
            powers=z["powers"].astype(np.int32),
            coef=z["coef"].astype(np.float64),
            intercept=float(z["intercept"]),
            poly_degree=int(z["poly_degree"]),
            iso_x=z["iso_x"] if "iso_x" in z else None,
            iso_y=z["iso_y"] if "iso_y" in z else None,
        )


def from_numpy(d: Dict[str, Any]) -> TempModelWeights:
    """The port's weights from a field dict of numpy arrays and scalars,
    e.g. ``dataclasses.asdict`` of the JAX package's ``TempModelWeights``;
    packs (and so validates) the kernel tables."""
    names = {f.name for f in dataclasses.fields(TempModelWeights)}
    unknown = set(d) - names
    if unknown:
        raise ValueError(f"unknown TempModelWeights fields: {sorted(unknown)}")

    def arr(v, dtype):
        return None if v is None else np.array(v, dtype)

    w = TempModelWeights(
        name=str(d["name"]),
        feature_names=tuple(str(s) for s in d["feature_names"]),
        scaler_mean=arr(d["scaler_mean"], np.float64),
        scaler_scale=arr(d["scaler_scale"], np.float64),
        powers=arr(d["powers"], np.int32),
        coef=arr(d["coef"], np.float64),
        intercept=float(d["intercept"]),
        poly_degree=int(d["poly_degree"]),
        iso_x=arr(d.get("iso_x"), np.float64),
        iso_y=arr(d.get("iso_y"), np.float64),
    )
    w.tables
    return w


def interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor) -> torch.Tensor:
    """``jnp.interp(x, xp, fp)`` for increasing knots ``xp`` (repeats
    allowed): fp[0] below the first knot, fp[-1] above the last, linear in
    between; the interval of x is the last knot <= x (a NaN sorts above
    every knot), and a zero-width interval gives its left value.  So a NaN
    gives NaN, unless the last two knots coincide."""
    n = xp.numel()
    i = torch.searchsorted(xp, x.contiguous(), right=True)
    i = torch.clamp(torch.where(torch.isnan(x), n, i), 1, n - 1)
    x0, f0 = xp[i - 1], fp[i - 1]
    df = fp[i] - f0
    dx = xp[i] - x0
    dx0 = torch.abs(dx) <= _INTERP_EPS
    f = torch.where(dx0, f0, f0 + ((x - x0) / torch.where(dx0, 1.0, dx)) * df)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


def from_joblib(path: str, name: str = "model") -> TempModelWeights:
    """Export a reference joblib bundle ({model, use_features,
    isotonic_calibrator, ...}: StandardScaler -> PolynomialFeatures ->
    HuberRegressor, optionally an IsotonicRegression) into plain weights.
    Needs joblib and sklearn; raises ImportError where they are absent."""
    import joblib
    obj = joblib.load(path)
    if not (isinstance(obj, dict) and "model" in obj):
        raise RuntimeError(f"Unrecognized joblib format: {path}")
    pipe = obj["model"]
    sc = pipe.named_steps["standardscaler"]
    poly = pipe.named_steps["polynomialfeatures"]
    hub = pipe.named_steps["huberregressor"]
    iso = obj.get("isotonic_calibrator", None)
    iso_x = iso_y = None
    if iso is not None:
        iso_x = np.asarray(iso.X_thresholds_, np.float64)
        iso_y = np.asarray(iso.y_thresholds_, np.float64)
    return TempModelWeights(
        name=str(obj.get("name", name)),
        feature_names=tuple(obj["use_features"]),
        scaler_mean=np.asarray(sc.mean_, np.float64),
        scaler_scale=np.asarray(sc.scale_, np.float64),
        powers=np.asarray(poly.powers_, np.int32),
        coef=np.asarray(hub.coef_, np.float64).ravel(),
        intercept=float(np.ravel(hub.intercept_)[0]),
        poly_degree=int(poly.degree),
        iso_x=iso_x,
        iso_y=iso_y,
    )


def resolve_latest(pattern: str) -> str:
    """The newest file (by modification time) matching the glob ``pattern``."""
    matches = glob.glob(pattern)
    if not matches:
        raise RuntimeError(f"No model matches pattern: {pattern}")
    return max(matches, key=os.path.getmtime)


def load_reference_models(data_root: str) -> Tuple[TempModelWeights, TempModelWeights]:
    """(color_model, wide_model): the newest bundles of the reference layout
    under ``data_root``, COLOR on (L, a, b) and WIDE on (L, a, b, gray)."""
    color = from_joblib(resolve_latest(os.path.join(data_root, TEMP_COLOR_MODEL_GLOB)),
                        "color_model")
    wide = from_joblib(resolve_latest(os.path.join(data_root, TEMP_WIDE_MODEL_GLOB)),
                       "wide_model")
    if color.feature_names != ("L", "a", "b"):
        raise RuntimeError(f"Color model must use (L,a,b), got {color.feature_names}")
    if wide.feature_names != ("L", "a", "b", "gray"):
        raise RuntimeError(f"Wide model must use (L,a,b,gray), got {wide.feature_names}")
    return color, wide


def poly_powers(n_features: int, degree: int) -> np.ndarray:
    """sklearn PolynomialFeatures(include_bias=True) exponent table, in
    sklearn's term order (graded lexicographic as produced by its
    combinations-with-replacement enumeration)."""
    rows = [np.zeros(n_features, np.int32)]
    for d in range(1, degree + 1):
        for combo in combinations_with_replacement(range(n_features), d):
            e = np.zeros(n_features, np.int32)
            for i in combo:
                e[i] += 1
            rows.append(e)
    return np.stack(rows)
