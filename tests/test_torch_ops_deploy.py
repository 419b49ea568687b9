"""The native-4K deploy routes of the port's ops against the JAX functions
on the CPU, with the same numpy inputs: the seeded per-iteration ECC loop
(K4 or the plain moments, chosen by shape), the pooled unwrap, the sweep
``reconstruct`` and the non-fused IRLS with its K2 robust scale.

On the CPU the JAX side never reaches K4 (``registration.py:231-232``) or
K2 (``quantile_kernel.py:150-155``: it takes the histogram ladder), so the
gates are tolerances, each stated with its measured value.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from vistaf_tpu.ops import morphology as jmorph
from vistaf_tpu.ops import polyfit as jpoly
from vistaf_tpu.ops import registration as jreg
from vistaf_tpu.ops import unwrap as jun
from vistaf_tpu.ops.filters import gaussian_blur as j_blur
from vistaf_tpu.ops.warp import warp_affine_inverse_shear as j_shear

from vistaf_torch.kernels import ecc_kernel, quantile_kernel
from vistaf_torch.ops import morphology as tmorph
from vistaf_torch.ops import polyfit as tpoly
from vistaf_torch.ops import registration as treg
from vistaf_torch.ops import unwrap as tun
from vistaf_torch.ops.consts import DeviceConsts


def T(a):
    return torch.as_tensor(np.array(a))


def _ecc_pair(rng, h, w, th=0.003, tx=0.8, ty=-0.5):
    base = np.asarray(j_blur(jnp.asarray(rng.random((h, w)).astype(np.float32)), 3))
    M = np.array([[np.cos(th), -np.sin(th), tx], [np.sin(th), np.cos(th), ty]], np.float32)
    moved = np.asarray(j_shear(jnp.asarray(base), jnp.asarray(M)))
    yy, xx = np.mgrid[0:h, 0:w]
    mask = (yy - h / 2) ** 2 + (xx - w / 2) ** 2 <= (min(h, w) / 2 - 4) ** 2
    return base, moved, mask


@pytest.mark.parametrize("shape,seed", [((90, 110), True), ((90, 110), False),
                                        ((420, 470), True)])
def test_per_iteration_ecc_matches_jax(shape, seed):
    """``loop_kernel=False`` / a seeded solve: the per-iteration loop, with
    K4 below its budget and the plain moments above it (420x470 pads to
    424x512 > 200,000).  Gate 0.05 px on the translation, 5e-5 rad on the
    angle (measured 1.5e-5 px and 1.3e-8 rad at most)."""
    base, moved, mask = _ecc_pair(np.random.default_rng(21), *shape)
    p0 = np.array([0.002, 0.6, -0.3], np.float32) if seed else None
    kw = dict(mode="euclidean", max_iters=300, eps=1e-7, stride=2, sampler="shear",
              shear_k=4, stall_patience=25, loop_kernel=False)
    jw, jrho, _ = jreg.ecc_align(jnp.asarray(base), jnp.asarray(moved), jnp.asarray(mask),
                                 p_init=None if p0 is None else jnp.asarray(p0), **kw)
    w, rho, it = treg.ecc_align(T(base), T(moved), T(mask),
                                p_init=None if p0 is None else T(p0), **kw)
    jw = np.asarray(jw)
    assert int(it) > 0 and abs(float(rho) - float(jrho)) < 1e-4
    np.testing.assert_allclose(w.numpy()[:, 2], jw[:, 2], atol=0.05)
    assert abs(float(torch.atan2(w[1, 0], w[0, 0])) - np.arctan2(jw[1, 0], jw[0, 0])) < 5e-5


def test_ecc_routes_by_shape(monkeypatch):
    """K5 for an unseeded solve inside both budgets, K4 for a seeded one or
    with ``loop_kernel=False``, the plain moments above K4's budget."""
    calls = {"k4": 0, "k5": 0, "plain": 0}

    def counted(name, fn):
        def f(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return f

    monkeypatch.setattr(treg, "ecc_loop_euclidean", counted("k5", treg.ecc_loop_euclidean))
    monkeypatch.setattr(ecc_kernel, "gn_moments_euclidean",
                        counted("k4", ecc_kernel.gn_moments_euclidean))
    monkeypatch.setattr(treg, "_plain_moments", counted("plain", treg._plain_moments))
    rng = np.random.default_rng(22)
    kw = dict(max_iters=3, stride=2, shear_k=4, stall_patience=25)
    small = [T(a) for a in _ecc_pair(rng, 60, 70)]
    big = [T(a) for a in _ecc_pair(rng, 420, 470)]
    treg.ecc_align(*small, **kw)
    assert calls == {"k4": 0, "k5": 1, "plain": 0}
    treg.ecc_align(*small, p_init=torch.zeros(3), **kw)
    treg.ecc_align(*small, loop_kernel=False, **kw)
    assert calls["k5"] == 1 and calls["k4"] == 6 and calls["plain"] == 0
    treg.ecc_align(*big, **kw)
    assert calls["k5"] == 1 and calls["k4"] == 6 and calls["plain"] == 3


def test_pooled_unwrap_matches_jax():
    """``downsample=4``: the same 2 pi lattice index on >= 99.5% of the
    masked pixels (measured 100%)."""
    h, w = 150, 170
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    truth = 0.004 * (xx - 60) ** 2 + 0.09 * yy + 6.0 * np.exp(-((xx - 90) ** 2 + (yy - 70) ** 2)
                                                               / 900)
    wrapped = np.angle(np.exp(1j * truth)).astype(np.float32)
    mask = (yy - 75) ** 2 + (xx - 85) ** 2 <= 70 ** 2
    mask &= ~((yy - 40) ** 2 + (xx - 60) ** 2 <= 40)
    want = np.asarray(jun.unwrap_wls(jnp.asarray(wrapped), jnp.asarray(mask), cg_iters=16,
                                     downsample=4))
    got = tun.unwrap_wls(T(wrapped), T(mask), DeviceConsts("cpu"), cg_iters=16,
                         downsample=4).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    same_k = np.abs(got[mask] - want[mask]) < 1e-3
    assert same_k.mean() >= 0.995, same_k.mean()


def test_linear_upsample_matches_jax_image_resize():
    import jax
    x = np.random.default_rng(23).normal(size=(37, 59)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (148, 236), method="linear"))
    got = tun.resize_linear(T(x), (148, 236), DeviceConsts("cpu")).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_sweep_reconstruct_bit_equal(monkeypatch):
    """The port's sweep route (forced here below 1 Mpx), its dilation route
    and JAX's reconstruct reach the same mask, corner-only links included."""
    rng = np.random.default_rng(24)
    h, w = 300, 330
    yy, xx = np.mgrid[0:h, 0:w]
    mask = ((yy - 150) ** 2 + (xx - 140) ** 2 <= 110 ** 2) | ((yy - 40) ** 2 + (xx - 290) ** 2
                                                             <= 25 ** 2)
    mask &= rng.random((h, w)) > 0.08
    mask |= (yy == xx) & (xx > 240)                       # a diagonal corner-only chain
    seed = np.zeros((h, w), bool)
    seed[150, 140] = True
    seed[299, 299] = True
    want = np.asarray(jmorph.reconstruct(jnp.asarray(seed), jnp.asarray(mask)))
    np.testing.assert_array_equal(tmorph.reconstruct(T(seed), T(mask)).numpy(), want)
    monkeypatch.setattr(tmorph, "_SWEEP_MIN_PX", 0)
    np.testing.assert_array_equal(tmorph.reconstruct(T(seed), T(mask)).numpy(), want)


def test_reconstruct_takes_the_sweeps_from_1_mpx(monkeypatch):
    """At 1 Mpx (the native-4K reliable mask) both packages take the axis
    sweeps; the masks agree bit for bit."""
    calls = []
    real = tmorph._sweep
    monkeypatch.setattr(tmorph, "_sweep", lambda *a, **k: calls.append(1) or real(*a, **k))
    yy, xx = np.mgrid[0:1000, 0:1000]
    mask = ((yy - 500) ** 2 + (xx - 480) ** 2 <= 400 ** 2) | ((yy < 60) & (xx > 900))
    seed = np.zeros((1000, 1000), bool)
    seed[500, 480] = True
    want = np.asarray(jmorph.reconstruct(jnp.asarray(seed), jnp.asarray(mask)))
    np.testing.assert_array_equal(tmorph.reconstruct(T(seed), T(mask)).numpy(), want)
    assert len(calls) >= 4 and want.sum() < mask.sum()


def _poly_scene(rng, h, w):
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32) / max(h, w)
    z = (0.5 * xx - 0.3 * yy + 0.4 * xx * xx - 0.2 * xx * yy + 0.1 * yy * yy
         + 0.01 * rng.standard_normal((h, w))).astype(np.float32)
    z[rng.random((h, w)) < 0.05] += 3.0
    z[rng.random((h, w)) < 0.01] = np.nan
    m = ((yy - 0.45) ** 2 + (xx - 0.5) ** 2) <= 0.4 ** 2
    return z, m


@pytest.mark.parametrize("order", [1, 2])
def test_irls_with_k2_matches_jax(order):
    """The non-fused IRLS: the port's robust scale is K2's bisection pair,
    JAX's on the CPU the histogram ladder; the coefficients agree within
    1e-3 of the largest (measured 5.6e-6 at order 1, 1.7e-6 at order 2)."""
    z, m = _poly_scene(np.random.default_rng(25), 120, 150)
    jc, jfit = jpoly.robust_polyfit2d(jnp.asarray(z), jnp.asarray(m), order=order, iters=4,
                                      percentile_method="hist_pallas", resigma_iters=2,
                                      fused=False)
    c, fit = tpoly.robust_polyfit2d(T(z), T(m), order=order, iters=4, resigma_iters=2,
                                    fused=False)
    jc = np.asarray(jc)
    assert np.abs(c.numpy() - jc).max() <= 1e-3 * np.abs(jc).max()
    np.testing.assert_allclose(fit.numpy(), np.asarray(jfit), rtol=0,
                               atol=1e-3 * np.abs(np.asarray(jfit)).max())


def test_polyfit_routes_by_shape(monkeypatch):
    """``fused=True`` takes K7 inside its budget, the IRLS with K2 above it
    (600x600 pads to 600x640 > 300,000)."""
    calls = {"k2": 0}
    real = quantile_kernel.masked_median_mad

    def counted(*a, **k):
        calls["k2"] += 1
        return real(*a, **k)

    monkeypatch.setattr(tpoly, "masked_median_mad", counted)
    rng = np.random.default_rng(26)
    z, m = _poly_scene(rng, 100, 100)
    tpoly.robust_polyfit2d(T(z), T(m), iters=4, resigma_iters=2)
    assert calls["k2"] == 0
    z, m = _poly_scene(rng, 600, 600)
    c, _ = tpoly.robust_polyfit2d(T(z), T(m), iters=4, resigma_iters=2)
    assert calls["k2"] == 2 and torch.isfinite(c).all()
