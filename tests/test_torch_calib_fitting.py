"""The port's calibration fitting (``vistaf_torch/calib/{fitting,huber,
isotonic,groupkfold}.py``) and ``utils/michelson.py`` against the JAX
package's on the CPU, with the cases of ``tests/test_calib_fitting.py`` and
``tests/test_trainers.py``'s fast tests.

- ``fitting``, ``isotonic``, ``groupkfold`` and ``michelson`` are numpy
  copies: every result equal, bit for bit.
- ``huber`` runs as float64 tensors (here on the CPU): the same iteration
  count, ``sigma`` within 1e-8 relative, and the coefficients within 1e-8
  relative of the largest.  The polynomial pipeline's bias column
  duplicates the intercept's, so only ``coef[0] + intercept`` is
  determined; that sum is held to 1e-8 relative and the split, which the
  normal equations' rounding sets in both packages, to 1e-4 absolute (it
  moves by ~3e-6 on these cases).
"""
import numpy as np
import pytest
import torch

from vistaf_tpu.calib import fitting as jfitting
from vistaf_tpu.calib import groupkfold as jgroupkfold
from vistaf_tpu.calib import huber as jhuber
from vistaf_tpu.calib import isotonic as jisotonic
from vistaf_tpu.utils import michelson as jmichelson

from vistaf_torch.calib import fitting, groupkfold, huber, isotonic
from vistaf_torch.utils import michelson
from torch_threads import single_torch_thread  # noqa: F401  (autouse)

HUBER_RTOL, SPLIT_ATOL = 1e-8, 1e-4
CANDIDATES = ("linear0", "linear", "poly2", "sat_exp", "growth", "hinge_saturating")


def _growth_data(rng, n=75, noise=2.0):
    x = np.linspace(0, 0.25, n)
    y = np.maximum(1.6 * (np.exp(9.7 * x) - 1.0) + rng.normal(scale=noise, size=x.shape), 0.0)
    return x, y


P2H_X = np.array([0.5, 0.65, 0.8, 1.0])
P2H_Y = np.array([1.90935, 1.9477, 2.01821, 2.07255])


@pytest.mark.parametrize("name", ["fit_linear0", "fit_linear", "fit_poly2", "fit_exp",
                                  "fit_power", "fit_sat_exp_grid", "fit_sat_exp_lm",
                                  "fit_sat_exp_shift_grid", "fit_growth",
                                  "fit_hinge_saturating"])
def test_each_fit_is_bit_equal(name, rng):
    x = rng.random(40) * 3 + 0.1
    cases = [(x, 2.5 * x + 1.0 + rng.normal(scale=0.01, size=40)), _growth_data(rng),
             (P2H_X, P2H_Y)]
    for xs, ys in cases:
        np.testing.assert_equal(getattr(fitting, name)(xs, ys), getattr(jfitting, name)(xs, ys))


def test_lm_fit_is_bit_equal(rng):
    x, y = _growth_data(rng)
    f = lambda v, a, b: a * (np.exp(b * np.maximum(v, 0)) - 1)   # noqa: E731
    kw = dict(p0=[max(y.max(), 1e-6), 1.0], bounds=([0.0, 0.0], [np.inf, np.inf]))
    np.testing.assert_equal(fitting.lm_fit(f, x, y, **kw), jfitting.lm_fit(f, x, y, **kw))


@pytest.mark.parametrize("case", ["growth", "p2h", "h2f_anchored"])
def test_fit_best_model_is_bit_equal(case, rng):
    if case == "growth":
        x, y = _growth_data(rng, 50, 0.5)
        cands = CANDIDATES
    elif case == "p2h":
        x, y, cands = P2H_X, P2H_Y, ("hinge_saturating", "growth")
    else:
        x, y = _growth_data(rng, 30, 1.0)
        x, y = np.concatenate([np.zeros(20), x]), np.concatenate([np.zeros(20), y])
        cands = CANDIDATES
    got, want = fitting.fit_best_model(x, y, cands), jfitting.fit_best_model(x, y, cands)
    np.testing.assert_equal(got, want)
    assert got[1] == sorted(got[1], key=lambda d: d["rmse"])


def _assert_huber_close(t, j):
    assert t.n_iter == j.n_iter
    assert abs(t.sigma - j.sigma) <= HUBER_RTOL * j.sigma
    scale = np.abs(j.coef).max()
    np.testing.assert_allclose(t.coef[1:], j.coef[1:], rtol=0, atol=HUBER_RTOL * scale)


def test_huber_fit_matches_jax(rng):
    """The plain linear fit (no bias column): every coefficient and the
    intercept within 1e-8 relative."""
    X = rng.normal(size=(400, 3))
    y = X @ np.array([2.0, -1.0, 0.5]) + 0.3 + rng.normal(scale=0.1, size=400)
    y[::50] += 8.0  # outliers
    for eps, alpha in ((1.35, 1e-4), (1.2, 1e-6)):
        t = huber.huber_fit(torch.as_tensor(X), torch.as_tensor(y), epsilon=eps, alpha=alpha)
        j = jhuber.huber_fit(X, y, epsilon=eps, alpha=alpha)
        _assert_huber_close(t, j)
        assert abs(t.coef[0] - j.coef[0]) <= HUBER_RTOL * np.abs(j.coef).max()
        assert abs(t.intercept - j.intercept) <= HUBER_RTOL * abs(j.intercept)
        np.testing.assert_allclose(t.predict(X), j.predict(X), rtol=0, atol=1e-8)


@pytest.mark.parametrize("degree,n_feat,alpha", [(1, 3, 1e-6), (2, 3, 1e-6), (3, 4, 1e-4)])
def test_fit_huber_poly_matches_jax(degree, n_feat, alpha, rng):
    """The trainers' pipeline (StandardScaler -> PolynomialFeatures ->
    Huber) on feature-like samples with outliers."""
    n = 600
    T = rng.uniform(20, 40, n)
    X = (np.array([130, 165, 90, 110])[:n_feat] + np.outer(T - 30, [2.0, -1.5, 0.8, 1.8][:n_feat])
         + rng.normal(scale=2.0, size=(n, n_feat)))
    y = T + 0.002 * (T - 30) ** 3
    y[::37] += 5.0
    t = huber.fit_huber_poly(X, y, degree, epsilon=1.2, alpha=alpha, device="cpu")
    j = jhuber.fit_huber_poly(X, y, degree, epsilon=1.2, alpha=alpha)
    np.testing.assert_array_equal(t.powers, j.powers)
    np.testing.assert_allclose(t.scaler_mean, j.scaler_mean, rtol=1e-14)
    np.testing.assert_allclose(t.scaler_scale, j.scaler_scale, rtol=1e-14)
    _assert_huber_close(t.fit_, j.fit_)
    s_t, s_j = t.fit_.coef[0] + t.fit_.intercept, j.fit_.coef[0] + j.fit_.intercept
    assert abs(s_t - s_j) <= HUBER_RTOL * abs(s_j)
    assert abs(t.fit_.intercept - j.fit_.intercept) <= SPLIT_ATOL
    np.testing.assert_allclose(t.predict(X), j.predict(X), rtol=0, atol=1e-7)


def test_huber_median_and_min_norm_init_are_numpy():
    v = torch.tensor([3.0, 1.0, 4.0, 1.5], dtype=torch.float64)
    assert float(huber._median(v)) == np.median(v.numpy())
    assert float(huber._median(v[:3])) == np.median(v[:3].numpy())
    rng = np.random.default_rng(1)
    A = np.column_stack([np.ones(50), rng.normal(size=(50, 3)), np.ones(50)])
    y = rng.normal(size=50)
    np.testing.assert_allclose(
        huber._lstsq_min_norm(torch.as_tensor(A), torch.as_tensor(y)).numpy(),
        np.linalg.lstsq(A, y, rcond=None)[0], rtol=0, atol=1e-12)


def test_isotonic_is_bit_equal(rng):
    x = rng.normal(size=200) * 5 + 25
    y = x + rng.normal(scale=1.0, size=200)
    x[10:20] = x[0]                       # tied x, averaged first
    w = rng.uniform(0.5, 2.0, size=200)
    np.testing.assert_array_equal(isotonic.pava(y, w), jisotonic.pava(y, w))
    got, want = isotonic.fit_isotonic(x, y), jisotonic.fit_isotonic(x, y)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    q = np.linspace(10, 40, 101)
    np.testing.assert_array_equal(isotonic.isotonic_predict(*got, q),
                                  jisotonic.isotonic_predict(*want, q))


@pytest.mark.parametrize("n_groups,per_group,splits", [(14, 5, 6), (7, 2, 6), (40, 3, 5)])
def test_group_kfold_is_equal(n_groups, per_group, splits, rng):
    groups = np.repeat(rng.permutation(n_groups) + 20, per_group)
    np.testing.assert_array_equal(groupkfold.group_kfold_indices(groups, splits),
                                  jgroupkfold.group_kfold_indices(groups, splits))
    X, y = np.zeros((len(groups), 1)), np.zeros(len(groups))
    for (a, b), (c, d) in zip(groupkfold.group_kfold_split(X, y, groups, splits),
                              jgroupkfold.group_kfold_split(X, y, groups, splits)):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)
    with pytest.raises(ValueError):
        groupkfold.group_kfold_indices(groups, n_groups + 1)


def test_michelson_is_equal():
    colors = {"white": (255, 255, 255), "red": (230, 40, 35), "skin": (50, 50, 51),
              "unit": (0.2, 0.5, 0.9)}
    for rgb in colors.values():
        assert michelson.michelson_contrast(rgb, michelson.SKIN_BLACK) == \
            jmichelson.michelson_contrast(rgb, jmichelson.SKIN_BLACK)
        assert michelson.relative_luminance(rgb) == jmichelson.relative_luminance(rgb)
    assert michelson.rank_pigments(colors) == jmichelson.rank_pigments(colors)
    assert michelson.hex_to_rgb("#323233") == jmichelson.hex_to_rgb("#323233")
    assert abs(michelson.michelson_contrast((255, 255, 255), michelson.SKIN_BLACK) - 0.938) < 0.01
