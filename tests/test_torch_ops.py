"""The port's plain ops against the JAX package's, on the CPU, with the
same numpy inputs on both sides.

Boolean and integer outputs (morphology, distance-eroded masks,
components, carrier bins) must be bit-equal.  Float outputs get an f32
tolerance with its reason beside it: mostly the summation order of a
matmul or a reduction, which XLA and PyTorch choose differently.
"""
import dataclasses

import jax
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from vistaf_tpu.calib import scalar_models as jsm
from vistaf_tpu.ftp import demod as jdemod
from vistaf_tpu.ops import color as jcolor
from vistaf_tpu.ops import components as jcomp
from vistaf_tpu.ops import distance as jdist
from vistaf_tpu.ops import fftops as jfft
from vistaf_tpu.ops import filters as jfilt
from vistaf_tpu.ops import morphology as jmorph
from vistaf_tpu.ops import percentile as jpct
from vistaf_tpu.ops import registration as jreg
from vistaf_tpu.ops import unwrap as jun
from vistaf_tpu.ops import warp as jwarp
from vistaf_tpu.ops.polyfit import eval_poly2d as j_eval_poly2d
from vistaf_tpu.pipelines import force as jforce
from vistaf_tpu.utils.synthetic import scaled_ftp_config

from vistaf_torch import config as tcfg
from vistaf_torch.calib import scalar_models as tsm
from vistaf_torch.ftp import demod as tdemod
from vistaf_torch.ops import color as tcolor
from vistaf_torch.ops import components as tcomp
from vistaf_torch.ops import distance as tdist
from vistaf_torch.ops import fftops as tfft
from vistaf_torch.ops import filters as tfilt
from vistaf_torch.ops import morphology as tmorph
from vistaf_torch.ops import percentile as tpct
from vistaf_torch.ops import registration as treg
from vistaf_torch.ops import unwrap as tun
from vistaf_torch.ops import warp as twarp
from vistaf_torch.ops.consts import DeviceConsts
from vistaf_torch.ops.padding import pad_last2
from vistaf_torch.ops.polyfit import eval_poly2d as t_eval_poly2d
from vistaf_torch.pipelines import force as tforce
from torch_threads import single_torch_thread  # noqa: F401  (autouse)

T = torch.as_tensor


def J(a):
    """A writable numpy copy (JAX hands out read-only buffers)."""
    return np.array(a)


@pytest.fixture
def consts():
    return DeviceConsts("cpu")


def _blobs(rng, h=64, w=80, n=6, extra=0.0):
    """Boolean mask of a few random disks (plus optional speckle)."""
    yy, xx = np.mgrid[0:h, 0:w]
    m = np.zeros((h, w), bool)
    for _ in range(n):
        cy, cx, r = rng.integers(0, h), rng.integers(0, w), rng.integers(3, 14)
        m |= (yy - cy) ** 2 + (xx - cx) ** 2 <= r * r
    return m | (rng.random((h, w)) < extra)


# --------------------------------------------------------------- padding / color
@pytest.mark.parametrize("mode,jmode", [("symmetric", "symmetric"), ("reflect", "reflect"),
                                        ("replicate", "edge"), ("constant", "constant")])
def test_pad_modes_match_numpy(mode, jmode):
    x = np.random.default_rng(0).normal(size=(2, 5, 7)).astype(np.float32)
    pad = (3, 6, 4, 2) if mode != "reflect" else (3, 4, 4, 2)
    want = np.pad(x, ((0, 0), (pad[2], pad[3]), (pad[0], pad[1])), mode=jmode)
    np.testing.assert_array_equal(pad_last2(T(x), pad, mode).numpy(), want)


def test_bgr_to_gray_bit_equal():
    """Against the jitted JAX function, as the JAX pipelines run it."""
    bgr = np.random.default_rng(1).integers(0, 256, size=(2, 31, 45, 3)).astype(np.uint8)
    jgray = jax.jit(jcolor.bgr_to_gray)
    want = np.stack([J(jgray(jnp.asarray(b))) for b in bgr])
    np.testing.assert_array_equal(tcolor.bgr_to_gray(T(bgr)).numpy(), want)


def test_bgr_to_gray_on_every_bgr_value():
    """All 2^24 8-bit BGR values bit-equal to the jitted JAX gray: XLA's CPU
    code contracts the weighted sum into two FMAs, which round a sum on a .5
    tie the other way on 1,166 values of plain float32 arithmetic (15 of the
    1182x1182 crop of the composed multimodal frame, whose deploy force then
    stood 0.32% from JAX's given JAX's alignment)."""
    v = np.arange(2 ** 24, dtype=np.uint32)
    bgr = np.stack([(v >> 16) & 255, (v >> 8) & 255, v & 255], axis=-1).astype(np.uint8)
    bgr = bgr.reshape(4096, 4096, 3)
    want = J(jax.jit(jcolor.bgr_to_gray)(jnp.asarray(bgr)))
    got = tcolor.bgr_to_gray(T(bgr)).numpy()
    assert got.dtype == np.float32
    assert int((got != want).sum()) == 0


# --------------------------------------------------------------- filters
@pytest.mark.parametrize("n,taps", [(236, 71), (5, 9), (2, 71), (1, 3)])
def test_band_matrix_bit_equal(n, taps):
    """The REFLECT_101 folding of the banded blur matrix, also where the
    kernel is wider than the axis (the fold wraps more than once)."""
    k = tuple(np.hanning(taps + 2)[1:-1] / np.hanning(taps + 2).sum())
    assert tfilt.band_matrix(n, k).tobytes() == jfilt._band_matrix(n, k).tobytes()


@pytest.mark.parametrize("sigma", [0.4, 1.1547, 8.66])
def test_gaussian_blur_matches(consts, sigma):
    x = np.random.default_rng(2).uniform(0, 255, size=(40, 52)).astype(np.float32)
    want = J(jfilt.gaussian_blur(jnp.asarray(x), sigma))
    got = tfilt.gaussian_blur(T(x), sigma, consts).numpy()
    # same banded-matmul association; only the dot's summation order differs
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-4)


def test_box_gradient_and_masked_smooth_match(consts):
    rng = np.random.default_rng(3)
    x = rng.uniform(0, 255, size=(33, 47)).astype(np.float32)
    m = rng.random((33, 47)) > 0.3
    np.testing.assert_allclose(tfilt.box_filter(T(m.astype(np.float32)), 5, consts).numpy(),
                               J(jfilt.box_filter(jnp.asarray(m.astype(np.float32)), 5)),
                               rtol=0, atol=1e-5)     # sums of small integers
    # the Sobel shift-adds are elementwise in the same order: f32 rounding only
    np.testing.assert_allclose(tfilt.gradient_magnitude(T(x)).numpy(),
                               J(jfilt.gradient_magnitude(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-4)
    np.testing.assert_allclose(
        tfilt.masked_gaussian_smooth(T(x), T(m), 1.73, consts).numpy(),
        J(jfilt.masked_gaussian_smooth(jnp.asarray(x), jnp.asarray(m), 1.73)),
        rtol=1e-5, atol=2e-4)
    np.testing.assert_array_equal(tfilt.hanning_window(13, 20), jfilt.hanning_window(13, 20))


# --------------------------------------------------------------- percentile helpers
def test_masked_mean_min_max(consts):
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 20, 30)).astype(np.float32)
    x[0, 3, 3] = np.nan
    m = rng.random((20, 30)) > 0.5
    for fn_t, fn_j, tol in ((tpct.masked_mean, jpct.masked_mean, 1e-6),
                            (tpct.masked_min, jpct.masked_min, 0.0),
                            (tpct.masked_max, jpct.masked_max, 0.0)):
        got = fn_t(T(x), T(m)).numpy()
        want = np.stack([J(fn_j(jnp.asarray(p), jnp.asarray(m))) for p in x])
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    empty = np.zeros_like(m)
    assert float(tpct.masked_max(T(x[1]), T(empty))) == 0.0


# --------------------------------------------------------------- morphology
@pytest.mark.parametrize("k,iters", [(3, 1), (5, 2), (7, 1), (15, 1)])
def test_dilate_erode_close_bit_equal(k, iters):
    m = _blobs(np.random.default_rng(k), extra=0.02)
    fp = tmorph.ellipse_kernel(k, k)
    np.testing.assert_array_equal(fp, jmorph.ellipse_kernel(k, k))
    for ft, fj in ((tmorph.dilate, jmorph.dilate), (tmorph.erode, jmorph.erode),
                   (tmorph.close, jmorph.close)):
        np.testing.assert_array_equal(ft(T(m), fp, iters).numpy(),
                                      J(fj(jnp.asarray(m), fp, iters)))


def test_dilate_batches_planes():
    rng = np.random.default_rng(5)
    m = np.stack([_blobs(rng, extra=0.01), _blobs(rng, extra=0.01)])
    fp = tmorph.ellipse_kernel(3, 3)
    got = tmorph.dilate(T(m), fp).numpy()
    for i in range(2):
        np.testing.assert_array_equal(got[i], J(jmorph.dilate(jnp.asarray(m[i]), fp)))


def test_reconstruct_bit_equal():
    rng = np.random.default_rng(6)
    m = _blobs(rng, n=8, extra=0.03)
    seed = rng.random(m.shape) > 0.995
    np.testing.assert_array_equal(tmorph.reconstruct(T(seed), T(m)).numpy(),
                                  J(jmorph.reconstruct(jnp.asarray(seed), jnp.asarray(m))))


# --------------------------------------------------------------- distance
@pytest.mark.parametrize("max_dist", [0, 4, 42])
def test_distance_transforms_bit_equal(max_dist):
    m = _blobs(np.random.default_rng(7), h=70, w=90, n=5)
    for ft, fj in ((tdist.distance_transform_chamfer3, jdist.distance_transform_chamfer3),
                   (tdist.distance_transform_edt, jdist.distance_transform_edt)):
        np.testing.assert_array_equal(ft(T(m), max_dist=max_dist).numpy(),
                                      J(fj(jnp.asarray(m), max_dist=max_dist)))


@pytest.mark.parametrize("metric", ["chamfer3", "euclid"])
def test_erode_by_distance_bit_equal(metric):
    m = _blobs(np.random.default_rng(8), n=5)
    np.testing.assert_array_equal(
        tdist.erode_by_distance(T(m), 1, metric=metric).numpy(),
        J(jdist.erode_by_distance(jnp.asarray(m), 1, metric=metric)))


# --------------------------------------------------------------- components
def test_label_bit_equal():
    m = _blobs(np.random.default_rng(9), n=9, extra=0.02)
    np.testing.assert_array_equal(tcomp.label(T(m)).numpy(), J(jcomp.label(jnp.asarray(m))))


@pytest.mark.parametrize("seed_pool", [1, 4])
def test_dominant_component_bit_equal(seed_pool):
    rng = np.random.default_rng(10)
    m = _blobs(rng, h=96, w=96, n=7, extra=0.01)
    np.testing.assert_array_equal(
        tcomp.dominant_component(T(m), seed_pool=seed_pool).numpy(),
        J(jcomp.dominant_component(jnp.asarray(m), seed_pool=seed_pool)))


def test_dominant_component_seed_ties():
    """Several disks of one radius: the EDT argmax ties, and both libraries
    take the first maximum, so the same blob is kept."""
    h = w = 96
    yy, xx = np.mgrid[0:h, 0:w]
    m = np.zeros((h, w), bool)
    for cy, cx in ((20, 70), (20, 20), (70, 45)):
        m |= (yy - cy) ** 2 + (xx - cx) ** 2 <= 12 ** 2
    for pool in (1, 4):
        got = tcomp.dominant_component(T(m), seed_pool=pool).numpy()
        np.testing.assert_array_equal(got, J(jcomp.dominant_component(jnp.asarray(m),
                                                                       seed_pool=pool)))
        assert 0 < got.sum() < m.sum()
    # an all-speckle mask has no pooled interior: the full-res seed path
    speck = np.random.default_rng(11).random((64, 64)) > 0.7
    np.testing.assert_array_equal(tcomp.dominant_component(T(speck), 4).numpy(),
                                  J(jcomp.dominant_component(jnp.asarray(speck), 4)))


@pytest.mark.parametrize("min_area", [0, 40])
def test_filter_components_by_peak_bit_equal(min_area):
    rng = np.random.default_rng(12)
    m = _blobs(rng, n=8, extra=0.01)
    v = rng.random(m.shape).astype(np.float32)
    thr = np.float32(0.97)
    np.testing.assert_array_equal(
        tcomp.filter_components_by_peak(T(m), T(v), T(thr), min_area_px=min_area).numpy(),
        J(jcomp.filter_components_by_peak(jnp.asarray(m), jnp.asarray(v),
                                          jnp.asarray(thr), min_area_px=min_area)))


# --------------------------------------------------------------- fftops
def test_carrier_cascade_bins_equal_and_refinement_close(consts):
    rng = np.random.default_rng(13)
    mag = np.abs(rng.normal(size=(64, 80))).astype(np.float32)
    mag[30, 55] = 40.0
    mag[60, 70] = 50.0          # stronger, but far from the centre row
    x, y = tfft.carrier_peak_cascade(T(mag), 4)
    jx, jy = jfft.carrier_peak_cascade(jnp.asarray(mag), 4)
    assert (int(x), int(y)) == (int(jx), int(jy)) == (55, 30)
    fx, fy = tfft.refine_peak_parabolic_log(T(mag), x, y)
    gx, gy = jfft.refine_peak_parabolic_log(jnp.asarray(mag), jx, jy)
    assert abs(float(fx) - float(gx)) < 1e-5 and abs(float(fy) - float(gy)) < 1e-5


def test_sparse_patch_idft_and_ramp(consts):
    rng = np.random.default_rng(14)
    patch = (rng.normal(size=(2, 21, 21)) + 1j * rng.normal(size=(2, 21, 21))
             ).astype(np.complex64)
    got = tfft.ifft2_sparse_patch(T(patch), 64, 72, 22, 26, consts).numpy()
    want = J(jfft.ifft2_sparse_patch(jnp.asarray(patch), 64, 72, 22, 26))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)   # complex64 matmul order
    ramp = tfft.frac_ramp(64, 72, T(np.float32(0.3)), T(np.float32(-0.2)), consts).numpy()
    np.testing.assert_allclose(ramp, J(jfft.frac_ramp(64, 72, 0.3, -0.2)), atol=1e-6)


# --------------------------------------------------------------- warp / registration
@pytest.mark.parametrize("border", ["constant0", "reflect"])
def test_shear_warp_matches(border):
    rng = np.random.default_rng(15)
    S = rng.random((4, 40, 56)).astype(np.float32)
    th = 0.01
    M = np.array([[np.cos(th), -np.sin(th), 0.7], [np.sin(th), np.cos(th), -1.3]],
                 np.float32)
    got = twarp.shear_warp_stack(T(S), T(M), K=4, border=border).numpy()
    want = J(jwarp.shear_warp_stack(jnp.asarray(S), jnp.asarray(M), K=4, border=border))
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)   # f32 tap sums


def test_translate_bilinear_matches():
    x = np.random.default_rng(16).uniform(0, 255, size=(50, 60)).astype(np.float32)
    for dx, dy in ((0.37, -1.6), (-5.2, 3.05)):
        got = twarp.translate_bilinear(T(x), T(np.float32(dx)), T(np.float32(dy)),
                                       max_shift=8).numpy()
        want = J(jwarp.translate_bilinear(jnp.asarray(x), dx, dy, max_shift=8))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_phase_correlate_matches():
    rng = np.random.default_rng(17)
    base = jfilt.gaussian_blur(jnp.asarray(rng.random((96, 128)).astype(np.float32)), 2.0)
    moved = jwarp.translate_bilinear(base, 2.3, -1.4, max_shift=8)
    win = jfilt.hanning_window(96, 128)
    jdx, jdy, _ = jreg.phase_correlate(base, moved, jnp.asarray(win))
    dx, dy, _ = treg.phase_correlate(T(J(base)), T(J(moved)), T(win))
    # whitened spectra: FFT rounding differs between pocketfft and XLA
    assert abs(float(dx) - float(jdx)) < 1e-3 and abs(float(dy) - float(jdy)) < 1e-3


def test_ecc_align_matches_jax_solver(consts):
    """The port's ecc_align (K5's plain version on the CPU) against the JAX
    ecc_align on the CPU (its XLA while loop, LU solve): the JAX loop
    kernel test's bounds."""
    rng = np.random.default_rng(18)
    base = J(jfilt.gaussian_blur(jnp.asarray(rng.random((90, 110)).astype(np.float32)), 3))
    th, tx, ty = 0.003, 0.8, -0.5
    M = np.array([[np.cos(th), -np.sin(th), tx], [np.sin(th), np.cos(th), ty]], np.float32)
    moved = J(jwarp.warp_affine_inverse_shear(jnp.asarray(base), jnp.asarray(M)))
    yy, xx = np.mgrid[0:90, 0:110]
    mask = (yy - 45) ** 2 + (xx - 55) ** 2 <= 40 ** 2
    kw = dict(mode="euclidean", max_iters=300, eps=1e-7, stride=2, sampler="shear",
              shear_k=4, stall_patience=25, loop_kernel=True)
    jw, jrho, _ = jreg.ecc_align(jnp.asarray(base), jnp.asarray(moved), jnp.asarray(mask),
                                 **kw)
    w, rho, _ = treg.ecc_align(T(base), T(moved), T(mask), **kw)
    assert abs(float(rho) - float(jrho)) < 1e-4
    np.testing.assert_allclose(w.numpy()[:, 2], J(jw)[:, 2], atol=5e-3)
    jw = J(jw)
    assert abs(float(torch.atan2(w[1, 0], w[0, 0])) - np.arctan2(jw[1, 0], jw[0, 0])) < 5e-5
    # the affine motion type on the same scene: the plain moments (JAX
    # fuses the euclidean mode only), translations within 5e-3 px, the
    # linear part within 5e-5
    kw["mode"] = "affine"
    jw, jrho, _ = jreg.ecc_align(jnp.asarray(base), jnp.asarray(moved), jnp.asarray(mask),
                                 **kw)
    w, rho, _ = treg.ecc_align(T(base), T(moved), T(mask), **kw)
    assert abs(float(rho) - float(jrho)) < 1e-4
    np.testing.assert_allclose(w.numpy()[:, 2], J(jw)[:, 2], atol=5e-3)
    np.testing.assert_allclose(w.numpy()[:, :2], J(jw)[:, :2], atol=5e-5)
    with pytest.raises(ValueError, match="mode"):
        treg.ecc_align(T(base), T(moved), T(mask), mode="homography")


# --------------------------------------------------------------- unwrap / polyfit
def test_unwrap_wls_matches(consts):
    h, w = 60, 76
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    truth = 0.004 * (xx - 30) ** 2 + 0.06 * yy + 2.0 * np.exp(-((xx - 40) ** 2 + (yy - 30) ** 2) / 200)
    wrapped = np.angle(np.exp(1j * truth)).astype(np.float32)
    mask = _blobs(np.random.default_rng(19), h, w, n=3) | ((yy - 30) ** 2 + (xx - 38) ** 2 < 500)
    want = J(jun.unwrap_wls(jnp.asarray(wrapped), jnp.asarray(mask), cg_iters=16))
    got = tun.unwrap_wls(T(wrapped), T(mask), consts, cg_iters=16).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    # congruent: both snap to wrapped + 2 pi k with the same k
    np.testing.assert_allclose(got[mask], want[mask], rtol=0, atol=1e-4)


def test_eval_poly2d_matches():
    coef = np.array([0.3, -0.2, 0.1, 0.05, -0.04, 0.02], np.float32)
    np.testing.assert_allclose(t_eval_poly2d(24, 31, T(coef), 2).numpy(),
                               J(j_eval_poly2d(24, 31, jnp.asarray(coef), 2)), atol=1e-6)


# --------------------------------------------------------------- demodulation
def test_demod_pair_carrier_bins_and_amplitude(consts):
    """The rfft2 pair path on slice-sized crops of the synthetic scene, with
    the bad-pixel repair off (its percentile thresholds differ by method on
    the JAX CPU path, see test_torch_slice)."""
    from vistaf_tpu.utils.synthetic import synthetic_pair
    jc = scaled_ftp_config(480, 640).deploy().replace(bad_pixel_enable=False)
    tc = tcfg.ftp_config_from_dict(dataclasses.asdict(jc))
    ref, de = synthetic_pair(480, 640, jc)
    gray = [J(jcolor.bgr_to_gray(jnp.asarray(f)))[143:379, 204:440] for f in (ref, de)]
    from vistaf_tpu.ops.geometry import circular_apodization
    apo = circular_apodization(236, 236, 118, 118, 117, jc.apod_taper_px)
    jr, jd = jdemod.ftp_complex_demod_pair(jnp.asarray(gray[0]), jnp.asarray(gray[1]),
                                           jnp.asarray(apo), jc)
    tr, td = tdemod.ftp_complex_demod_pair(T(gray[0]), T(gray[1]), T(apo), tc, consts)
    assert tr.fft_shape == jr.fft_shape == (272, 272)
    np.testing.assert_array_equal(np.round(tr.peak_f.numpy()), np.round(J(jr.peak_f)))
    np.testing.assert_allclose(tr.k.numpy(), J(jr.k), atol=1e-4)
    for a, b in ((tr.amp, jr.amp), (td.amp, jd.amp)):
        b = J(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-4 * np.abs(b).max())


# --------------------------------------------------------------- calibration / force
@pytest.mark.parametrize("model", [
    {"type": "hinge_saturating", "params": {"a": 2.08, "b": 4.2, "c": -1.7e-9}},
    {"type": "growth", "params": {"a": 1.62, "b": 9.76}},
    {"type": "poly2", "params": {"c0": 0.1, "c1": 2.0, "c2": -0.5}},
    {"type": "sat_exp_shift", "params": {"a": 1.0, "b": 3.0, "x0": 0.2},
     "origin_correction": 0.01},
])
def test_scalar_models_match(model):
    x = np.linspace(-0.5, 1.5, 41).astype(np.float32)
    np.testing.assert_allclose(tsm.predict(model, T(x)).numpy(),
                               J(jsm.predict(model, jnp.asarray(x))), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tsm.predict(model, x.astype(float), xp=np),
                               jsm.predict(model, x.astype(float), xp=np), rtol=1e-12)


def test_volume_reductions_match():
    rng = np.random.default_rng(20)
    hm = (rng.random((50, 60)) * 0.3).astype(np.float32)
    hm[rng.random((50, 60)) > 0.9] = np.nan
    roi = rng.random((50, 60)) > 0.2
    got = tforce.depth_map_to_volume_cm3(T(hm), T(roi), 0.1664, 0.01)
    want = jforce.depth_map_to_volume_cm3(jnp.asarray(hm), jnp.asarray(roi), 0.1664, 0.01)
    for a, b in zip(got, want):
        assert abs(float(a) - float(b)) <= 1e-6 * abs(float(b))   # f32 sum order
