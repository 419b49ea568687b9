"""The temperature path's ops in the port against their JAX functions, from
the same numpy inputs.  Tolerances, with their reasons:

- rounded gray, morphology and empty-mask fallbacks: equal; the chroma 1e-4
  absolute (XLA on the CPU may contract a product and a sum into one fused
  multiply-add: one ulp);
- masked means over a mask: 1e-6 relative (summation order);
- shift-add blurs: the same products and the same left-to-right sums, so
  1e-4 absolute on 0-255 data (XLA on the CPU may contract a product and a
  sum into one fused multiply-add);
- banded-matmul blurs: 1e-3 absolute on 0-255 data (matmul blocking orders
  a 161-term sum differently);
- rounded outputs (8-bit blur, quantised inpaint): a sum that lands on a .5
  boundary may round the other way, so at most one step on < 0.1% of pixels;
- the shear rotation: 1e-4 absolute on values in [0, 1] (sin and cos of the
  shear factors from two libraries);
- the bandpass: 1e-4 of max |z| (complex float32 matmuls and rfft2 from two
  libraries).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vistaf_tpu.ops import color as jcolor
from vistaf_tpu.ops import fftops as jfft
from vistaf_tpu.ops import filters as jfilters
from vistaf_tpu.ops import inpaint as jinpaint
from vistaf_tpu.ops import morphology as jmorph
from vistaf_tpu.ops import percentile as jpct
from vistaf_tpu.ops import warp as jwarp

from vistaf_torch.ops import color, fftops, filters, inpaint, morphology, percentile, warp
from vistaf_torch.ops.consts import DeviceConsts
from torch_threads import single_torch_thread  # noqa: F401  (autouse)

CPU = DeviceConsts("cpu")


def T(a):
    return torch.as_tensor(np.ascontiguousarray(a))


@pytest.mark.parametrize("shape,sx,sy,ksize,route", [
    ((48, 80), 0.0, 0.0, 5, "shift"),          # the 5x5 feature blur
    ((96, 128), 1.0, 6.0, 0, "shift"),         # the oriented blur, 9 x 49 taps
    ((64, 96), 3.0, 0.0, 0, "shift"),          # 25 taps
    ((96, 160), 9.0, 0.0, 0, "matmul"),        # 73 taps > 63: the illumination blur's route
    ((6, 40), 2.5, 0.0, 0, "matmul"),          # radius 10 >= 6 rows
])
def test_gaussian_blur_vpu_routes(rng, shape, sx, sy, ksize, route):
    x = np.round(rng.random(shape) * 255).astype(np.float32)
    want = np.asarray(jfilters.gaussian_blur(jnp.asarray(x), sx, sy, ksize=ksize,
                                             u8=ksize > 0, vpu=True))
    got = filters.gaussian_blur(T(x), sx, CPU, sigma_y=sy, ksize=ksize, u8=ksize > 0,
                                vpu=True).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 if route == "shift" else 1e-3)
    ky = len(filters.gaussian_kernel1d(sy if sy > 0 else sx, ksize, u8=ksize > 0))
    kx = len(filters.gaussian_kernel1d(sx, ksize, u8=ksize > 0))
    takes_shift = (max(kx, ky) <= filters.SHIFT_ADD_MAX_TAPS
                   and (ky - 1) // 2 < shape[0] and (kx - 1) // 2 < shape[1])
    assert takes_shift == (route == "shift")


def test_gaussian_blur_u8_round_gray_and_chroma(rng):
    bgr = rng.integers(0, 256, size=(40, 72, 3)).astype(np.uint8)
    x = bgr[..., 1].astype(np.float32)
    want = np.asarray(jfilters.gaussian_blur_u8_round(jnp.asarray(x), 5, vpu=True))
    got = filters.gaussian_blur_u8_round(T(x), 5, CPU, vpu=True).numpy()
    assert np.abs(got - want).max() <= 1.0 and (got != want).mean() < 1e-3
    np.testing.assert_array_equal(color.bgr_to_gray(T(bgr)).numpy(),
                                  np.asarray(jcolor.bgr_to_gray(jnp.asarray(bgr))))
    a = np.round(rng.random((30, 50)) * 255).astype(np.float32)
    b = np.round(rng.random((30, 50)) * 255).astype(np.float32)
    np.testing.assert_allclose(color.chroma_ab(T(a), T(b)).numpy(),
                               np.asarray(jcolor.chroma_ab(jnp.asarray(a), jnp.asarray(b))),
                               rtol=0, atol=1e-4)


@pytest.mark.parametrize("kh,kw", [(31, 3), (7, 3), (5, 9)])
def test_rect_open_close_bit_equal(rng, kh, kw):
    m = rng.random((60, 90)) > 0.55
    fp = morphology.rect_kernel(kh, kw)
    assert np.array_equal(fp, jmorph.rect_kernel(kh, kw))
    for tf, jf in ((morphology.open_, jmorph.open_), (morphology.close, jmorph.close)):
        assert np.array_equal(tf(T(m), fp).numpy(), np.asarray(jf(jnp.asarray(m), fp)))


def test_masked_reductions_fallback(rng):
    x = rng.normal(size=(20, 30)).astype(np.float32)
    x[3, 4] = np.nan
    m = rng.random((20, 30)) > 0.5
    none = np.zeros_like(m)
    for tf, jf in ((percentile.masked_mean, jpct.masked_mean),
                   (percentile.masked_min, jpct.masked_min),
                   (percentile.masked_max, jpct.masked_max)):
        assert float(tf(T(x), T(none), fallback=1e9)) == 1e9
        assert float(tf(T(x), T(none))) == 0.0
        np.testing.assert_allclose(float(tf(T(x), T(m), fallback=1e9)),
                                   float(jf(jnp.asarray(x), jnp.asarray(m), fallback=1e9)),
                                   rtol=1e-6)


@pytest.mark.parametrize("angle", [8.0, -40.0])
def test_rotate_stack_shear_matches(rng, angle):
    h, w = 72, 104
    stack = rng.random((h, w, 2)).astype(np.float32)
    center = (w / 2.0, h / 2.0)
    want = np.asarray(jwarp.rotate_stack_shear(jnp.asarray(stack), angle, center))
    # the port's stack is channel-first
    got = warp.rotate_stack_shear(T(np.moveaxis(stack, -1, 0)), torch.tensor(angle),
                                  center).numpy()
    np.testing.assert_allclose(np.moveaxis(got, 0, -1), want, rtol=0, atol=1e-4)
    s = (rng.random(h) * 40 - 20).astype(np.float32)
    want_l = np.asarray(jwarp.line_shift_frac(jnp.asarray(stack), jnp.asarray(s), 1, 0, 5))
    got_l = warp.line_shift_frac(T(stack), T(s), 1, 0, 5).numpy()
    np.testing.assert_allclose(got_l, want_l, rtol=0, atol=1e-6)
    np.testing.assert_allclose(warp.rotation_matrix(center, angle).numpy(),
                               np.asarray(jwarp.rotation_matrix(center, angle)),
                               rtol=1e-6, atol=1e-5)


def test_inpaint_within_roi_quantized(rng):
    h, w = 48, 64
    yy, xx = np.mgrid[0:h, 0:w]
    roi = (yy - 24) ** 2 + (xx - 32) ** 2 <= 20 ** 2
    z = (20.0 + 0.2 * xx + 0.1 * yy + rng.normal(scale=0.3, size=(h, w))).astype(np.float32)
    z[~roi] = np.nan
    z[20:24, 30:35] = np.nan                      # a hole to fill
    fill = ~np.isfinite(z) & roi
    want = np.asarray(jinpaint.inpaint_within_roi(jnp.asarray(z), jnp.asarray(roi),
                                                  jnp.asarray(fill), iters=16,
                                                  quantize_u8=True))
    got = inpaint.inpaint_within_roi(T(z), T(roi), T(fill), iters=16, quantize_u8=True).numpy()
    assert np.array_equal(np.isfinite(got), np.isfinite(want))
    f = np.isfinite(want)
    step = (np.nanmax(z) - np.nanmin(z)) / 255.0
    d = np.abs(got[f] - want[f])
    assert d.max() <= step * 1.001 and (d > 1e-5).mean() < 1e-3
    assert np.isfinite(got[fill]).all()


@pytest.mark.parametrize("case", ["random", "nyquist"])
def test_carrier_peak_cascade_half(rng, case):
    hf, kw = 64, 65                               # rfft2 of a 64 x 128 plane
    mag = rng.random((hf, kw)).astype(np.float32)
    mag = np.round(mag * 8) / 8                   # equal bins: argmax takes the first
    if case == "nyquist":
        mag[hf // 2 + 3, kw - 1] = 50.0           # the largest right-half value sits
                                                  # in the Nyquist column
    kwargs = dict(prefer_near_center_row=True, peak_max_dy_frac=0.14)
    want = [int(v) for v in jfft.carrier_peak_cascade_half(jnp.asarray(mag), 6, **kwargs)]
    got = [int(v) for v in fftops.carrier_peak_cascade_half(T(mag), 6, **kwargs)]
    assert got == want
    if case == "nyquist":
        assert got == [kw - 1, hf // 2 + 3]


@pytest.mark.parametrize("k,py", [(20, 30), (3, 33), (63, 2)])
def test_ifft2_bandpass_dynamic_half(rng, k, py):
    h, w = 64, 128
    x = rng.normal(size=(h, w)).astype(np.float32)
    Rr = np.roll(np.fft.rfft2(x).astype(np.complex64), h // 2, axis=0)
    rows, cols = slice(8, 56), slice(16, 112)
    want = np.asarray(jfft.ifft2_bandpass_dynamic_half(
        jnp.asarray(Rr), jnp.int32(k), jnp.int32(py), 5.5, rows=rows, cols=cols))
    got = fftops.ifft2_bandpass_dynamic_half(T(Rr), torch.tensor(k), torch.tensor(py), 5.5,
                                             CPU, rows=rows, cols=cols).numpy()
    assert got.shape == want.shape == (48, 96)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())
