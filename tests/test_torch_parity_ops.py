"""The ops of the parity preset (``FTPConfig()``, ``scaled_ftp_config(h, w)``)
in the port against the JAX package's, on the CPU, with the same seeded
numpy inputs on both sides.

Exact where the arithmetic is the same: the sort percentiles (the JAX
float32 position arithmetic, then a sort), the top-k carrier pick (ties on
the lower flat index), the largest component and the hole detection (box
sums of 0/1 values, chamfer distances).  Elsewhere a stated float32
tolerance: the summation order of a matmul, an FFT or a reduction, which
XLA and PyTorch choose differently.
"""
import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from vistaf_tpu.ftp import demod as jdemod
from vistaf_tpu.ftp.pipeline import detect_internal_holes as j_detect_internal_holes
from vistaf_tpu.ops import color as jcolor
from vistaf_tpu.ops import components as jcomp
from vistaf_tpu.ops import fftops as jfft
from vistaf_tpu.ops import filters as jfilt
from vistaf_tpu.ops import inpaint as jinpaint
from vistaf_tpu.ops import percentile as jpct
from vistaf_tpu.ops import polyfit as jpoly
from vistaf_tpu.ops import registration as jreg
from vistaf_tpu.ops import unwrap as jun
from vistaf_tpu.ops import warp as jwarp
from vistaf_tpu.ops.geometry import circular_apodization
from vistaf_tpu.utils.synthetic import scaled_ftp_config, synthetic_pair

from vistaf_torch import config as tcfg
from vistaf_torch.ftp import demod as tdemod
from vistaf_torch.ftp.pipeline import detect_internal_holes as t_detect_internal_holes
from vistaf_torch.ops import components as tcomp
from vistaf_torch.ops import fftops as tfft
from vistaf_torch.ops import inpaint as tinpaint
from vistaf_torch.ops import percentile as tpct
from vistaf_torch.ops import polyfit as tpoly
from vistaf_torch.ops import registration as treg
from vistaf_torch.ops import unwrap as tun
from vistaf_torch.ops import warp as twarp
from vistaf_torch.ops.consts import DeviceConsts
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


def _bits_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype, a.shape, b.shape)
    assert a.tobytes() == b.tobytes(), (a, b)


# --------------------------------------------------------------- sort percentiles
QS = (0.0, 8.0, 25.0, 50.0, 92.0, 95.0, 98.0, 99.7, 99.9, 100.0, 37.3)


@pytest.mark.parametrize("case", ["nan_mask", "empty", "none", "all_nan", "one"])
def test_sort_percentile_bit_equal(case):
    """np.percentile over the mask by the JAX float32 arithmetic: the same
    bits, a tuple q and each scalar q, with NaNs and infinities excluded, an
    empty selection's fallback and ``mask=None``."""
    rng = np.random.default_rng(30)
    h, w = 37, 53
    x = (rng.normal(size=(h, w)) * 40.0).astype(np.float32)
    x[rng.random((h, w)) < 0.05] = np.nan
    x[3, 4], x[5, 6] = np.inf, -np.inf
    m = {"nan_mask": rng.random((h, w)) < 0.6, "empty": np.zeros((h, w), bool),
         "none": None, "all_nan": np.ones((h, w), bool), "one": np.zeros((h, w), bool)}[case]
    if case == "all_nan":
        x[:] = np.nan
    if case == "one":
        m[7, 9] = True
    jm = None if m is None else jnp.asarray(m)
    tm = None if m is None else T(m)
    _bits_equal(tpct.masked_percentile(T(x), tm, QS, fallback=-1.5).numpy(),
                J(jpct.masked_percentile(jnp.asarray(x), jm, QS, fallback=-1.5)))
    for q in (50.0, 25.0, 99.9):
        _bits_equal(tpct.masked_percentile(T(x), tm, q).numpy(),
                    J(jpct.masked_percentile(jnp.asarray(x), jm, q)))
    _bits_equal(tpct.masked_median(T(x), tm).numpy(), J(jpct.masked_median(jnp.asarray(x), jm)))
    assert tpct.get_percentile_fn("sort") is tpct.masked_percentile


def test_sort_percentile_leading_batch_bit_equal():
    """A (2, 3, H, W) stack with one (H, W) mask broadcast over it gives one
    value a plane, (2, 3, Q) for a tuple, each the JAX value of that plane."""
    rng = np.random.default_rng(31)
    x = rng.normal(size=(2, 3, 29, 41)).astype(np.float32)
    x[rng.random(x.shape) < 0.03] = np.nan
    m = rng.random((29, 41)) < 0.7
    got = tpct.masked_percentile(T(x), T(m), (25.0, 50.0, 99.7)).numpy()
    one = tpct.masked_percentile(T(x), T(m), 92.0).numpy()
    assert got.shape == (2, 3, 3) and one.shape == (2, 3)
    for i in range(2):
        for j in range(3):
            _bits_equal(got[i, j], J(jpct.masked_percentile(jnp.asarray(x[i, j]), jnp.asarray(m),
                                                            (25.0, 50.0, 99.7))))
            _bits_equal(one[i, j], J(jpct.masked_percentile(jnp.asarray(x[i, j]),
                                                            jnp.asarray(m), 92.0)))


# --------------------------------------------------------------- IRLS polyfit, sort route
@pytest.mark.parametrize("order,iters,resigma", [(2, 6, 6), (1, 6, 6), (2, 4, 2)])
def test_sort_route_irls_matches(order, iters, resigma):
    """The non-fused IRLS with the sort median/MAD against the JAX
    ``_robust_polyfit2d_xla`` with ``percentile_method='sort'``: coefficients
    within 1e-5 relative (the 6x6 normal equations' summation order)."""
    rng = np.random.default_rng(32)
    h, w = 70, 90
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    z = (0.4 + 2e-2 * xx - 3e-2 * yy + 1e-4 * xx * xx - 2e-4 * xx * yy + 3e-4 * yy * yy
         + rng.normal(scale=0.05, size=(h, w))).astype(np.float32)
    z[rng.random((h, w)) > 0.96] += 4.0
    z[10, 10] = np.nan
    m = (yy - 35) ** 2 + (xx - 45) ** 2 <= 33 ** 2
    jc, jfit = jpoly.robust_polyfit2d(jnp.asarray(z), jnp.asarray(m), order=order, iters=iters,
                                      resigma_iters=resigma, percentile_method="sort")
    c, fit = tpoly.robust_polyfit2d(T(z), T(m), order=order, iters=iters, resigma_iters=resigma,
                                    fused=False, percentile_method="sort")
    jc = J(jc)
    np.testing.assert_allclose(c.numpy(), jc, rtol=0, atol=1e-5 * np.abs(jc).max())
    np.testing.assert_allclose(fit.numpy(), J(jfit), rtol=0, atol=1e-5 * np.abs(J(jfit)).max())


# --------------------------------------------------------------- bilinear gather warps
@pytest.mark.parametrize("border", ["reflect", "reflect101", "constant0"])
def test_sample_bilinear_and_inverse_map_match(border):
    """Coordinates far outside the plane exercise every fold; 1e-6."""
    rng = np.random.default_rng(33)
    img = rng.normal(size=(23, 31)).astype(np.float32)
    sy = rng.uniform(-30, 50, size=(17, 19)).astype(np.float32)
    sx = rng.uniform(-40, 70, size=(17, 19)).astype(np.float32)
    got = twarp.sample_bilinear(T(img), T(sy), T(sx), border=border).numpy()
    want = J(jwarp.sample_bilinear(jnp.asarray(img), jnp.asarray(sy), jnp.asarray(sx),
                                   border=border))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    th = 0.1
    M = np.array([[np.cos(th), -np.sin(th), 3.3], [np.sin(th), np.cos(th), -2.2]], np.float32)
    got = twarp.warp_affine_inverse_map(T(img), T(M), border=border).numpy()
    want = J(jwarp.warp_affine_inverse_map(jnp.asarray(img), jnp.asarray(M), border=border))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_sample_bilinear_stack_matches():
    """The channel-first stack against the JAX (H, W, C) one: clamped
    indices, zeros outside the plane; 1e-6."""
    rng = np.random.default_rng(34)
    st = rng.normal(size=(23, 31, 4)).astype(np.float32)
    sy = rng.uniform(-2, 25, size=(17, 19)).astype(np.float32)
    sx = rng.uniform(-2, 33, size=(17, 19)).astype(np.float32)
    sy[0, :3] = [0.0, 22.0, 22.5]
    sx[0, :3] = [30.0, 0.0, 30.0]
    got = twarp.sample_bilinear_stack(T(st.transpose(2, 0, 1).copy()), T(sy), T(sx)).numpy()
    want = J(jwarp.sample_bilinear_stack(jnp.asarray(st), jnp.asarray(sy), jnp.asarray(sx)))
    np.testing.assert_allclose(got, want.transpose(2, 0, 1), rtol=0, atol=1e-6)
    assert (got[:, 0, 2] == 0).all() and (got[:, 0, :2] != 0).all()


# --------------------------------------------------------------- gather-sampler ECC
def _ecc_scene(th, tx, ty, n=(90, 110), seed=35):
    rng = np.random.default_rng(seed)
    base = J(jfilt.gaussian_blur(jnp.asarray(rng.random(n).astype(np.float32)), 3))
    M = np.array([[np.cos(th), -np.sin(th), tx], [np.sin(th), np.cos(th), ty]], np.float32)
    moved = J(jwarp.warp_affine_inverse_map(jnp.asarray(base), jnp.asarray(M)))
    yy, xx = np.mgrid[0:n[0], 0:n[1]]
    mask = (yy - n[0] // 2) ** 2 + (xx - n[1] // 2) ** 2 <= (min(n) // 2 - 5) ** 2
    return base, moved, mask


@pytest.mark.parametrize("seeded", [False, True])
def test_gather_ecc_align_matches(seeded):
    """The parity ECC (euclidean, bilinear gather, stride 1, no stall
    patience) against the JAX ``ecc_align``: warp within 5e-3 px, rho
    within 1e-4; unseeded and seeded near the answer.  The iteration counts
    may differ (seeded: 5 here, 8 in JAX): the port sums the moments in
    float64, JAX in float32, and the loop stops at a change of rho below
    1e-7."""
    base, moved, mask = _ecc_scene(0.01, 1.8, -1.5)
    kw = dict(mode="euclidean", max_iters=300, eps=1e-7, stride=1, sampler="gather",
              stall_patience=0)
    p0 = np.array([0.008, 1.5, -1.2], np.float32) if seeded else None
    jw, jrho, jit = jreg.ecc_align(jnp.asarray(base), jnp.asarray(moved), jnp.asarray(mask),
                                   p_init=None if p0 is None else jnp.asarray(p0), **kw)
    w, rho, it = treg.ecc_align(T(base), T(moved), T(mask),
                                p_init=None if p0 is None else T(p0), **kw)
    jw = J(jw)
    assert abs(float(rho) - float(jrho)) < 1e-4
    np.testing.assert_allclose(w.numpy()[:, 2], jw[:, 2], atol=5e-3)
    assert abs(float(torch.atan2(w[1, 0], w[0, 0])) - np.arctan2(jw[1, 0], jw[0, 0])) < 5e-5
    assert 1 <= int(it) < 300 and 1 <= int(jit) < 300


def test_gather_ecc_stop_is_not_rounding_noise():
    """With the moments summed in float64 the stopping iteration and the
    warp do not move when every input pixel moves by one float32 ulp (the
    card's and the CPU's blurs differ by as much): the same count, the warp
    within 1e-4 px."""
    base, moved, mask = _ecc_scene(0.004, 1.1, -0.7, n=(120, 150), seed=42)
    rng = np.random.default_rng(43)
    runs = []
    for k in range(3):
        jig = [(1 + rng.integers(-1, 2, size=a.shape) * 2.0 ** -23).astype(np.float32)
               if k else 1.0 for a in (base, moved)]
        runs.append(treg.ecc_align(T(base * jig[0]), T(moved * jig[1]), T(mask),
                                   sampler="gather"))
    for w, rho, it in runs[1:]:
        assert int(it) == int(runs[0][2])
        np.testing.assert_allclose(w.numpy(), runs[0][0].numpy(), rtol=0, atol=1e-4)


def test_gather_ecc_failure_gives_identity():
    """A flat template: the lambda denominator is 0 at the first iteration,
    cv2's StsNoConv; both sides return the identity warp and NaN rho."""
    _, moved, mask = _ecc_scene(0.0, 1.0, 0.5)
    flat = np.full_like(moved, 0.4)
    jw, jrho, jit = jreg.ecc_align(jnp.asarray(flat), jnp.asarray(moved), jnp.asarray(mask),
                                   sampler="gather")
    w, rho, it = treg.ecc_align(T(flat), T(moved), T(mask), sampler="gather")
    eye = np.eye(2, 3, dtype=np.float32)
    np.testing.assert_array_equal(w.numpy(), eye)
    np.testing.assert_array_equal(J(jw), eye)
    assert np.isnan(float(rho)) and np.isnan(float(jrho))
    assert int(it) == int(jit) == 1


# --------------------------------------------------------------- top-k carrier search
def _spectrum_with_ties():
    """A (64, 80) magnitude plane with the mirror symmetry of a real
    image's spectrum, |F(cy + dy, cx + dx)| == |F(cy - dy, cx - dx)|, bit
    for bit, and a second pair of equal right-half peaks in two rows."""
    rng = np.random.default_rng(36)
    h, w = 64, 80
    mag = np.abs(rng.normal(size=(h, w))).astype(np.float32)
    cy, cx = h // 2, w // 2
    for y in range(1, h):
        for x in range(1, w):
            mag[2 * cy - y, 2 * cx - x] = mag[y, x]
    mag[cy + 2, cx + 13] = mag[cy - 2, cx - 13] = 40.0      # the carrier and its mirror
    mag[cy - 3, cx + 9] = mag[cy + 3, cx - 9] = 40.0        # a tied twin in the right half
    mag[cy + 25, cx + 30] = mag[cy - 25, cx - 30] = 55.0    # stronger, far from the row
    mag[cy, cx] = 500.0                                      # DC, notched
    return mag


@pytest.mark.parametrize("right,near", [(True, True), (False, True), (True, False),
                                        (False, False)])
def test_topk_carrier_pick_exact_with_tied_mirror_peaks(right, near):
    """``find_top_peaks`` lists equal magnitudes lower flat index first, as
    ``lax.top_k`` does, and ``choose_carrier_peak`` takes the first of the
    strongest: the same bins as JAX under every filter setting."""
    mag = _spectrum_with_ties()
    h, w = mag.shape
    xs, ys, vals = tfft.find_top_peaks(T(mag), 4, 12)
    jxs, jys, jvals = jfft.find_top_peaks(jnp.asarray(mag), 4, 12)
    np.testing.assert_array_equal(xs.numpy(), J(jxs))
    np.testing.assert_array_equal(ys.numpy(), J(jys))
    _bits_equal(vals.numpy(), J(jvals))
    kw = dict(force_right_half_plane=right, prefer_near_center_row=near, peak_max_dy_frac=0.12)
    x, y = tfft.choose_carrier_peak(xs, ys, vals, h, w, **kw)
    jx, jy = jfft.choose_carrier_peak(jxs, jys, jvals, h, w, **kw)
    assert (int(x), int(y)) == (int(jx), int(jy))
    np.testing.assert_array_equal(tfft.dc_notch(T(mag), 4).numpy(),
                                  J(jfft.dc_notch(jnp.asarray(mag), 4)))
    if right and near:
        assert (int(x), int(y)) == (w // 2 + 9, h // 2 - 3)   # the upper of the tied pair


# --------------------------------------------------------------- full-fft2 demod pair
def _crop_pair(jc):
    ref, de = synthetic_pair(480, 640, jc)
    gray = [J(jcolor.bgr_to_gray(jnp.asarray(f)))[143:379, 204:440] for f in (ref, de)]
    apo = circular_apodization(236, 236, 118, 118, 117, jc.apod_taper_px)
    return gray, apo


@pytest.mark.parametrize("peak_method", ["topk", "cascade"])
def test_fft2_demod_pair_matches(consts, peak_method):
    """The parity demod (sort-percentile bad-pixel repair, median DC
    removal, full ``fft2``, the carrier search, Hann patch) on the slice's
    crop pair: carrier bins equal, refined peak within 1e-4 bin, the
    complex fields within 1e-4 of their largest modulus (FFT order)."""
    jc = scaled_ftp_config(480, 640).replace(peak_method=peak_method)
    tc = tcfg.ftp_config_from_dict(dataclasses.asdict(jc))
    (g0, g1), apo = _crop_pair(jc)
    jr, jd = jdemod.ftp_complex_demod_pair(jnp.asarray(g0), jnp.asarray(g1), jnp.asarray(apo), jc)
    tr, td = tdemod.ftp_complex_demod_pair(T(g0), T(g1), T(apo), tc, consts)
    assert tr.fft_shape == jr.fft_shape == (272, 272)
    np.testing.assert_array_equal(np.round(tr.peak_f.numpy()), np.round(J(jr.peak_f)))
    np.testing.assert_allclose(tr.peak_f.numpy(), J(jr.peak_f), atol=1e-4)
    np.testing.assert_allclose(tr.k.numpy(), J(jr.k), atol=1e-4)
    for a, b in ((tr, jr), (td, jd)):
        want = J(b.complex_demod)
        scale = np.abs(want).max()
        np.testing.assert_allclose(a.complex_demod.numpy(), want, rtol=0, atol=1e-4 * scale)
        np.testing.assert_allclose(a.i_norm.numpy(), J(b.i_norm), rtol=0, atol=1e-5)


def test_median_dc_removal_matches(consts):
    """The preprocessing under ``dc_remove_stat='median'`` with the sort
    percentiles: the bad-pixel thresholds are the JAX bits, so the repaired
    images agree to the stencil's rounding, without apodization too (the
    median then over every finite pixel)."""
    for apo_on in (True, False):
        jc = scaled_ftp_config(480, 640)
        tc = tcfg.ftp_config_from_dict(dataclasses.asdict(jc))
        (g0, g1), apo = _crop_pair(jc)
        pair = np.stack([g0, g1])
        ja = jnp.asarray(apo) if apo_on else None
        want = [J(jdemod._preprocess(jnp.asarray(g), ja, jc)[0]) for g in pair]
        got = tdemod.preprocess(T(pair), T(apo) if apo_on else None, tc, consts)[0].numpy()
        for a, b in zip(got, want):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-5 * np.abs(b).max())


# --------------------------------------------------------------- largest component
@pytest.mark.parametrize("case", ["blobs", "tie", "empty", "speckle"])
def test_largest_component_bit_equal(case):
    rng = np.random.default_rng(37)
    h, w = 64, 80
    yy, xx = np.mgrid[0:h, 0:w]
    if case == "blobs":
        m = _blobs(rng, h, w, n=9, extra=0.01)
    elif case == "tie":      # two disks of one area: the first root in row-major order
        m = ((yy - 40) ** 2 + (xx - 15) ** 2 <= 64) | ((yy - 15) ** 2 + (xx - 60) ** 2 <= 64)
    elif case == "empty":
        m = np.zeros((h, w), bool)
    else:
        m = rng.random((h, w)) > 0.75
    got = tcomp.largest_component(T(m)).numpy()
    np.testing.assert_array_equal(got, J(jcomp.largest_component(jnp.asarray(m))))
    if case == "tie":
        assert got[15, 60] and not got[40, 15]


# --------------------------------------------------------------- hole fill
def test_detect_internal_holes_bit_equal(consts):
    """Box-filter count fractions of 0/1 planes and chamfer distances: the
    same candidates as JAX, holes near the edge excluded."""
    rng = np.random.default_rng(38)
    h, w = 72, 88
    yy, xx = np.mgrid[0:h, 0:w]
    container = (yy - 36) ** 2 + (xx - 44) ** 2 <= 30 ** 2
    known = container & (rng.random((h, w)) > 0.08)
    known[30:33, 40:44] = False                     # a hole inside
    known[6:9, 40:44] = False                       # one by the edge
    for ksize, frac, dist in ((11, 0.7, 4), (5, 0.9, 2), (3, 0.5, 6)):
        got = t_detect_internal_holes(T(container), T(known), ksize, frac, dist, consts).numpy()
        want = J(j_detect_internal_holes(jnp.asarray(container), jnp.asarray(known), ksize,
                                         frac, dist))
        np.testing.assert_array_equal(got, want)
        assert got.any()


def test_float_inpaint_within_roi_matches():
    """The force path's float fill (``quantize_u8=False``) of holes in a
    ramp: the diffusion stencil in the same order, the initial mean summed
    in another order; 1e-5 of the range."""
    rng = np.random.default_rng(39)
    h, w = 48, 64
    yy, xx = np.mgrid[0:h, 0:w]
    roi = (yy - 24) ** 2 + (xx - 32) ** 2 <= 20 ** 2
    z = (-1.5 + 0.05 * xx - 0.02 * yy + rng.normal(scale=0.01, size=(h, w))).astype(np.float32)
    z[~roi] = np.nan
    z[20:24, 30:35] = np.nan
    fill = ~np.isfinite(z) & roi
    fill[10:12, 28:31] = True                   # known values to replace
    for iters in (24, 64):
        want = J(jinpaint.inpaint_within_roi(jnp.asarray(z), jnp.asarray(roi), jnp.asarray(fill),
                                             iters=iters))
        got = tinpaint.inpaint_within_roi(T(z), T(roi), T(fill), iters=iters).numpy()
        np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
        f = np.isfinite(want)
        np.testing.assert_allclose(got[f], want[f], rtol=0, atol=1e-5 * 4.0)
        assert np.isfinite(got[fill]).all()


# --------------------------------------------------------------- FFT-based DCT unwrap
H_DCT, W_DCT = 520, 544          # min side >= _DCT_FFT_MIN_PX: the FFT DCT


def _dense_poisson(rho):
    """The dense-matrix Poisson solve in float64."""
    h, w = rho.shape
    Dh, Dw = (tun._dct2_matrix(n).astype(np.float64) for n in (h, w))
    out = (Dh @ rho.astype(np.float64) @ Dw.T) / tun._poisson_denominator(h, w)
    out[0, 0] = 0.0
    return Dh.T @ out @ Dw


def test_fft_dct_poisson_solve_matches(consts):
    """At 520x544 the port's FFT DCT solve against the JAX one
    (``jax.scipy.fft.dct``) and the dense-matrix solve in float64: within
    1e-4 of the solution's largest value (the lowest modes divide by
    ~3e-5, which scales the FFTs' float32 rounding)."""
    assert not tun.dense_dct_solve((H_DCT, W_DCT))
    rng = np.random.default_rng(40)
    rho = rng.normal(size=(H_DCT, W_DCT)).astype(np.float32)
    got = tun._poisson_dct_solve(T(rho), consts).numpy()
    want = J(jun._poisson_dct_solve(jnp.asarray(rho)))
    dense = _dense_poisson(rho)
    scale = np.abs(dense).max()
    np.testing.assert_allclose(got, dense, rtol=0, atol=1e-4 * scale)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * scale)
    for d in (0, 1):
        x = rng.normal(size=(H_DCT, W_DCT)).astype(np.float32)
        back = tun.idct_ortho(tun.dct_ortho(T(x), d, consts), d, consts).numpy()
        np.testing.assert_allclose(back, x, rtol=0, atol=1e-5)


def test_fft_dct_unwrap_wls_matches(consts, monkeypatch):
    """A full-resolution 30-iteration unwrap at 520x544: against JAX and
    against the port's own dense-matrix DCT route on the same input (the
    switch moved past the plane).  The outputs are congruent, psi + 2 pi k,
    so the same k gives equal values: k agrees on >= 99.99% of the mask,
    where the values are within 1e-3."""
    rng = np.random.default_rng(41)
    yy, xx = np.mgrid[0:H_DCT, 0:W_DCT].astype(np.float32)
    truth = (4e-5 * (xx - 250) ** 2 + 0.03 * yy
             + 6.0 * np.exp(-((xx - 300) ** 2 + (yy - 240) ** 2) / 8000.0)).astype(np.float32)
    truth += rng.normal(scale=0.05, size=truth.shape).astype(np.float32)
    wrapped = np.angle(np.exp(1j * truth)).astype(np.float32)
    mask = (yy - 260) ** 2 + (xx - 272) ** 2 <= 250 ** 2
    got = tun.unwrap_wls(T(wrapped), T(mask), consts, cg_iters=30).numpy()
    want = J(jun.unwrap_wls(jnp.asarray(wrapped), jnp.asarray(mask), cg_iters=30))
    monkeypatch.setattr(tun, "_DCT_FFT_MIN_PX", 10 ** 6)
    dense = tun.unwrap_wls(T(wrapped), T(mask), DeviceConsts("cpu"), cg_iters=30).numpy()
    for other in (want, dense):
        np.testing.assert_array_equal(np.isnan(got), np.isnan(other))
        same = np.abs(got[mask] - other[mask]) < 1e-3
        assert same.mean() >= 0.9999, same.mean()
