"""How far rounding moves the temperature trainers' fits (the port, on the CPU).

    python scripts/trainer_rounding.py [--height 540 --width 960]

Writes the seeded series of ``chip_smoke.py``'s trainers phase
(``synthetic_tlc_series``: 7 temperatures x 2 frames a run, heating and
cooling) at the given size to a temporary directory, with the trainers'
real annulus scaled to it, then fits each model three times: with eight
PyTorch threads, with one (another reduction order), and with eight on
features perturbed by 1e-15 relative.  Prints one JSON line per case:

- ``cv``: the cross-validated mean RMSE of each candidate degree, as
  ``choose_degree_by_groupcv`` ranks them, for the colour and black
  trainers' frame-mean features (heating, cooling, global): how far the
  linear model wins, and how far rounding moves the other degrees;
- ``final``: each variant's degree-1 fit on all its frames (the trainers'
  final fit where the linear model wins): rounds, sigma, the coefficients'
  largest gap to the first run and the predictions' on the frames;
- ``pixels``: the black trainer's pixel-sample fit (4000 px an image) at
  degrees 1-3: the rounds of each run and the coefficients' largest gap to
  the first run (relative to the largest coefficient).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import cv2
import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from vistaf_torch.calib import groupkfold, huber  # noqa: E402
from vistaf_torch.trainers import temperature_black, temperature_color  # noqa: E402
from vistaf_torch.trainers import temperature_common as tc  # noqa: E402
from vistaf_torch.utils.synthetic import synthetic_tlc_series  # noqa: E402

TEMPS, FRAMES = list(range(20, 27)), 2


def fits(X, y, fn):
    """fn(X') for the three runs: 8 threads, 1 thread, 8 threads on X
    perturbed by 1e-15 relative."""
    rng = np.random.default_rng(0)
    out = []
    for trial in range(3):
        torch.set_num_threads(1 if trial == 1 else 8)
        Xp = X.astype(np.float64)
        if trial == 2:
            Xp = Xp * (1 + 1e-15 * rng.standard_normal(X.shape))
        out.append(fn(Xp, y))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--height", type=int, default=540)
    ap.add_argument("--width", type=int, default=960)
    args = ap.parse_args()
    h, w = args.height, args.width

    def scaled(pts):
        return tuple((int(round(x * w / 3840)), int(round(y * h / 2160))) for x, y in pts)

    with tempfile.TemporaryDirectory() as root:
        for stem, temps, seed, span in (("heating", TEMPS, 1, None),
                                        ("cooling", TEMPS[::-1], 2, (TEMPS[0], TEMPS[-1]))):
            per = [t for t in temps for _ in range(FRAMES)]
            for i, img in enumerate(synthetic_tlc_series(h, w, per, t_span=span, seed=seed), 1):
                assert cv2.imwrite(os.path.join(root, f"{stem}-{i}.jpg"), img)
        mask = tc.annulus_roi(h, w, scaled(temperature_color.INNER_CIRCLE),
                              scaled(temperature_color.OUTER_CIRCLE))
        heat = tc.load_images_sorted(os.path.join(root, "heating-*.jpg"))
        cool = tc.load_images_sorted(os.path.join(root, "cooling-*.jpg"))
        yh = np.repeat(np.asarray(TEMPS, float), FRAMES)
        yc = yh[::-1].copy()
        for kind, gray, degrees, alpha in (
                ("color", False, temperature_color.POLY_DEGREE_CANDIDATES,
                 temperature_color.HUBER_ALPHA),
                ("black", True, temperature_black.POLY_DEGREE_CANDIDATES,
                 temperature_black.HUBER_ALPHA)):
            Xh = tc.mean_features_for_sequence(heat, mask, gray, device="cpu")
            Xc = tc.mean_features_for_sequence(cool, mask, gray, device="cpu")
            for variant, X, y in (("heating", Xh, yh), ("cooling", Xc, yc),
                                  ("global", np.vstack([Xh, Xc]), np.concatenate([yh, yc]))):
                def cv(Xp, y):
                    rmse = []
                    for deg in degrees:
                        r = [np.sqrt(np.mean((y[te] - huber.fit_huber_poly(
                                Xp[tr], y[tr], deg, 1.2, alpha, device="cpu").predict(Xp[te]))
                                ** 2))
                             for tr, te in groupkfold.group_kfold_split(Xp, y, y.astype(int), 6)]
                        rmse.append(float(np.mean(r)))
                    return rmse
                print(json.dumps({"case": "cv", "trainer": kind, "variant": variant,
                                  "degrees": list(degrees), "mean_rmse_C": fits(X, y, cv)}))
                runs = fits(X, y, lambda Xp, y: huber.fit_huber_poly(Xp, y, 1, 1.2, alpha,
                                                                     device="cpu"))
                print(json.dumps({"case": "final", "trainer": kind, "variant": variant,
                                  "degree": 1, "rounds": [m.fit_.n_iter for m in runs],
                                  "sigma": [m.fit_.sigma for m in runs],
                                  "coef_gap": [float(np.abs(m.fit_.coef[1:] - runs[0].fit_.coef[1:])
                                                     .max() / np.abs(runs[0].fit_.coef).max())
                                               for m in runs],
                                  "predict_gap_C": [float(np.abs(m.predict(X) - runs[0].predict(X))
                                                          .max()) for m in runs]}))
        X, y = tc.pixel_samples_for_sequence(heat, mask, yh, temperature_black.PIXELS_PER_IMAGE,
                                             temperature_black.MAX_TOTAL_PIXEL_SAMPLES, 0,
                                             device="cpu")
        for deg in temperature_black.POLY_DEGREE_CANDIDATES:
            runs = fits(X, y, lambda Xp, y: huber.fit_huber_poly(
                Xp, y, deg, temperature_black.HUBER_EPSILON, temperature_black.HUBER_ALPHA,
                device="cpu"))
            base = runs[0].fit_.coef
            print(json.dumps({"case": "pixels", "samples": int(len(y)), "degree": deg,
                              "rounds": [m.fit_.n_iter for m in runs],
                              "coef_gap": [float(np.abs(m.fit_.coef[1:] - base[1:]).max()
                                                 / np.abs(base).max()) for m in runs]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
