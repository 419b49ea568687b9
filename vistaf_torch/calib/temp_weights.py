"""Temperature model weights as plain numpy arrays (JAX ``calib/temp_weights.py``).

A fitted temperature model is StandardScaler -> PolynomialFeatures ->
HuberRegressor, optionally followed by an isotonic calibrator.  The JAX
package exports those fitted parameters once into ``TempModelWeights``;
the port keeps the same fields, and ``from_numpy`` carries a JAX export
across.  ``from_joblib`` and ``load_reference_models`` (which need sklearn,
joblib and the reference artifacts) are not ported yet.

``TempModelWeights.tables`` packs the model into the float32 tables that
the fused per-pixel kernel and its plain version read (``kernels/temp_kernel.py``),
with the JAX Pallas kernel's roundings: every constant is the float32
rounding of a float64 value formed on the host.
"""
from __future__ import annotations

import dataclasses
import functools
import os
from itertools import combinations_with_replacement
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np


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
