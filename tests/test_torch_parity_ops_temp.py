"""The ops of the temperature parity preset (``TempConfig()``) in the port
against the JAX package's, on the CPU, with the same seeded numpy inputs on
both sides: the unfused LAB (``bgr_to_lab_u8``), the models' ``predict``
with its ``jnp.interp`` calibrator, the ``hist`` percentiles, the windowed
bandpass over the full shifted spectrum, ``invert_affine`` and the gather
rotation of the oriented blur.

Tolerances, each from what differs:
- LAB: the port takes XLA's arithmetic (each division by a constant a
  multiply by its float32 reciprocal, each power in float64 rounded once),
  but XLA contracts multiply-adds into FMAs and its ``pow`` is not
  correctly rounded; over all 2**24 BGR values 163 (9.7e-6 of them) land on
  the other side of a .5 boundary and differ by one 8-bit step, none by
  more.  The gate: under 2e-5 differ, none by more than one step.
- ``predict``: the same terms in the same order; XLA contracts each
  ``out + c * term`` into one FMA, so the sums differ by rounding: within
  2e-6 of the map's scale before the calibrator, times the calibrator's
  steepest slope after it (41.7 for the synthetic COLOR model).  NaN where
  JAX has NaN.
- ``hist`` percentiles: the same float32 steps and exact counts, bit-equal.
- the bandpass: two twiddle matmuls against the full-frame masked inverse
  FFT, and against the JAX function, within 1e-4 of the largest value.
- ``invert_affine``: 1e-6; the gather oriented blur: 1e-3 degC on the
  finite pixels, which agree (a sampling position moves by float32
  rounding of the rotation matrix, 1e-6 px).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vistaf_tpu.calib.temp_weights import TempModelWeights as JaxWeights
from vistaf_tpu.ops import color as jcolor
from vistaf_tpu.ops import fftops as jfft
from vistaf_tpu.ops import percentile as jpct
from vistaf_tpu.ops import warp as jwarp
from vistaf_tpu.temperature import inference as jinf

from vistaf_torch.calib.temp_weights import interp
from vistaf_torch.ops import color, fftops, percentile, warp
from vistaf_torch.ops.consts import DeviceConsts
from vistaf_torch.temperature import inference
from vistaf_torch.utils.synthetic import synthetic_deploy_temp_weights
from torch_threads import single_torch_thread  # noqa: F401  (autouse)

T = torch.as_tensor
CPU = DeviceConsts("cpu")


@pytest.fixture
def rng():
    return np.random.default_rng(0)


# --------------------------------------------------------------- LAB
def test_bgr_to_lab_u8_on_every_bgr_value():
    jlab = jax.jit(jcolor.bgr_to_lab_u8)
    g, r = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
    one, more, total = 0, 0, 0
    for b in range(256):
        bgr = np.stack([np.full_like(g, b), g, r], axis=-1).astype(np.float32)
        want = np.asarray(jlab(bgr))
        got = color.bgr_to_lab_u8(T(bgr)).numpy()
        d = np.abs(got - want).max(axis=-1)
        one += int((d == 1).sum())
        more += int((d > 1).sum())
        total += d.size
    assert total == 2 ** 24
    assert more == 0
    assert one / total < 2e-5, one


def test_bgr_to_lab_u8_on_uint8_and_chroma(rng):
    """uint8 input, and the chroma of the LAB planes, as the pipeline jits
    them: integer planes, so exact squares and sums, one rounding."""
    bgr = rng.integers(0, 256, size=(40, 56, 3)).astype(np.uint8)
    want = np.array(jax.jit(jcolor.bgr_to_lab_u8)(bgr))
    got = color.bgr_to_lab_u8(T(bgr)).numpy()
    assert got.dtype == np.float32 and got.shape == (40, 56, 3)
    assert np.abs(got - want).max() <= 1.0 and np.mean(got != want) < 1e-3
    np.testing.assert_array_equal(
        color.chroma_ab(T(want[..., 1]), T(want[..., 2])).numpy(),
        np.asarray(jax.jit(jcolor.chroma_ab)(want[..., 1], want[..., 2])))


# --------------------------------------------------------------- predict
def _features(rng, n_feat, shape=(48, 64)):
    """LAB-and-gray-like feature planes with a few NaNs."""
    X = rng.uniform(0, 255, size=shape + (n_feat,)).astype(np.float32)
    X[rng.random(shape) > 0.98] = np.nan
    return X


def _jax(m):
    return JaxWeights(**dataclasses.asdict(m))


@pytest.mark.parametrize("which", ["wide", "color", "color_repeated_knots",
                                   "color_uncalibrated"])
def test_predict_matches_jax(rng, which):
    color_m, wide_m = synthetic_deploy_temp_weights(seed=0)
    m = wide_m if which == "wide" else color_m
    if which == "color_repeated_knots":
        x = np.asarray(m.iso_x, np.float64).copy()
        x[10:13] = x[10]                                  # a knot three times
        x[-2] = x[-1]                                     # the last two coincide
        m = dataclasses.replace(m, iso_x=x)
    elif which == "color_uncalibrated":
        m = dataclasses.replace(m, iso_x=None, iso_y=None)
    X = _features(rng, len(m.feature_names))
    want = np.asarray(_jax(m).predict(jnp.asarray(X)))
    got = m.predict(T(X)).numpy()
    assert got.dtype == np.float32 and got.shape == X.shape[:-1]
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    f = np.isfinite(want)
    slope = 1.0
    if m.iso_x is not None:
        dx, dy = np.diff(m.iso_x), np.diff(m.iso_y)
        slope = max(1.0, float(np.max(dy[dx > 0] / dx[dx > 0])))
    scale = np.abs(want[f]).max()
    np.testing.assert_allclose(got[f], want[f], rtol=0, atol=2e-6 * scale * slope)
    if which == "color_repeated_knots":
        # NaN in, the last two knots equal: jnp.interp gives the knot's value
        assert not np.isnan(got).any()


def test_interp_edges_match_jnp_interp():
    xp = np.array([0.0, 1.0, 1.0, 2.0, 5.0, 5.0], np.float32)
    fp = np.array([10.0, 11.0, 13.0, 14.0, 20.0, 21.0], np.float32)
    x = np.array([-1.0, 0.0, 0.5, 1.0, 1.5, 2.0, 4.9, 5.0, 6.0, np.nan, np.inf, -np.inf],
                 np.float32)
    want = np.asarray(jnp.interp(jnp.asarray(x), jnp.asarray(xp), jnp.asarray(fp)))
    np.testing.assert_array_equal(interp(T(x), T(xp), T(fp)).numpy(), want)
    xp2 = xp[:-1]
    want2 = np.asarray(jnp.interp(jnp.asarray(x), jnp.asarray(xp2), jnp.asarray(fp[:-1])))
    got2 = interp(T(x), T(xp2), T(fp[:-1])).numpy()
    np.testing.assert_array_equal(got2, want2)
    assert np.isnan(got2[9])                          # NaN stays NaN


# --------------------------------------------------------------- hist
@pytest.mark.parametrize("case", range(6))
def test_hist_percentiles_bit_equal(rng, case):
    h, w = 40 + 7 * case, 64
    x = (rng.normal(size=(h, w)) * (1 + 20 * case)).astype(np.float32)
    if case % 2:
        x = np.round(x)                                # ties
    x[rng.random((h, w)) > 0.95] = np.nan
    m = rng.random((h, w)) > 0.3
    if case == 5:
        m[:] = False                                   # empty: the fallback
    q = float(rng.uniform(0, 100))
    fn, jfn = percentile.get_percentile_fn("hist"), jpct.get_percentile_fn("hist")
    np.testing.assert_array_equal(fn(T(x), T(m), q).numpy(),
                                  np.asarray(jfn(jnp.asarray(x), jnp.asarray(m), q)))
    qs = (5.0, 50.0, q)
    got = fn(T(x), T(m), qs).numpy()
    assert got.shape == (3,)
    np.testing.assert_array_equal(got, np.asarray(jfn(jnp.asarray(x), jnp.asarray(m), qs)))


# --------------------------------------------------------------- bandpass
@pytest.mark.parametrize("h,w,px,py,window", [
    (64, 128, 84, 30, False), (64, 128, 2, 62, True), (63, 97, 70, 33, False)])
def test_ifft2_bandpass_dynamic_full_spectrum(rng, h, w, px, py, window):
    x = rng.normal(size=(h, w)).astype(np.float32)
    F = np.fft.fftshift(np.fft.fft2(x)).astype(np.complex64)
    r = 5.5
    rows, cols = (slice(8, h - 8), slice(16, w - 16)) if window else (None, None)
    got = fftops.ifft2_bandpass_dynamic(T(F), torch.tensor(px), torch.tensor(py), r, CPU,
                                        rows=rows, cols=cols).numpy()
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    disk = (xx - px) ** 2 + (yy - py) ** 2 <= r * r
    full = np.fft.ifft2(np.fft.ifftshift(F * disk))
    if window:
        full = full[rows, cols]
    assert got.shape == full.shape
    np.testing.assert_allclose(got, full, rtol=0, atol=1e-4 * np.abs(full).max())
    want = np.asarray(jfft.ifft2_bandpass_dynamic(jnp.asarray(F), jnp.int32(px), jnp.int32(py),
                                                  r, rows=rows, cols=cols))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())


# --------------------------------------------------------------- warps
@pytest.mark.parametrize("angle", [7.5, -63.0])
def test_invert_affine_matches_jax(angle):
    M = np.asarray(jwarp.rotation_matrix((160.0, 120.0), angle, 1.1))
    M = M + np.array([[0.0, 0.02, 3.5], [-0.01, 0.0, -2.0]], np.float32)
    got = warp.invert_affine(T(M)).numpy()
    np.testing.assert_allclose(got, np.asarray(jwarp.invert_affine(jnp.asarray(M))),
                               rtol=1e-6, atol=1e-6)
    # and it is the inverse
    A = np.vstack([M, [0, 0, 1]]).astype(np.float64)
    B = np.vstack([got, [0, 0, 1]]).astype(np.float64)
    np.testing.assert_allclose(A @ B, np.eye(3), atol=1e-5)


@pytest.mark.parametrize("angle_rad", [0.06, -0.9, 1.3])
def test_oriented_blur_gather_matches_jax(rng, angle_rad):
    h, w = 72, 104
    yy, xx = np.mgrid[0:h, 0:w]
    roi = (yy - 36) ** 2 + (xx - 52) ** 2 <= 30 ** 2
    m = (25.0 + 0.05 * xx + 0.1 * yy + rng.normal(scale=0.5, size=(h, w))).astype(np.float32)
    m[~roi] = np.nan
    m[30:34, 40:44] = np.nan
    want = np.asarray(jinf.oriented_gaussian_blur(
        jnp.asarray(m), jnp.asarray(roi), jnp.float32(angle_rad), 3.0, 0.8, method="gather"))
    got = inference.oriented_gaussian_blur(T(m), T(roi), torch.tensor(angle_rad), 3.0, 0.8,
                                           CPU, method="gather").numpy()
    assert np.array_equal(np.isfinite(got), np.isfinite(want))
    f = np.isfinite(want)
    assert f.mean() > 0.3
    np.testing.assert_allclose(got[f], want[f], rtol=0, atol=1e-3)
