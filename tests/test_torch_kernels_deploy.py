"""K2, K4 and K6: the plain PyTorch versions (the CPU route of each wrapper)
against the JAX Pallas kernels in interpret mode, as the JAX kernel tests
run them, and every kernel's ``fits`` predicate against the JAX budget it
copies.  The same numpy inputs go to both sides.

Tolerances: K2 bit-equal (exact counts, the same f32 scalar arithmetic);
K4 1e-5 of the largest moment (plane sums in another order; measured
~3e-7); K6 the same NaN pattern and the same 2 pi lattice index on
>= 99.9% of the masked pixels (the sums differ in order; measured: every
pixel the same).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from vistaf_tpu.pallas import ecc_kernel as j_ecc
from vistaf_tpu.pallas import ecc_loop_kernel as j_loop
from vistaf_tpu.pallas import inpaint_kernel as j_inpaint
from vistaf_tpu.pallas import polyfit_kernel as j_polyfit
from vistaf_tpu.pallas import quantile_kernel as j_quantile
from vistaf_tpu.pallas import unwrap_kernel as j_unwrap
from vistaf_tpu.ops.warp import shear_warp_stack

from vistaf_torch.kernels import (ecc_kernel, ecc_loop_kernel, inpaint_kernel,
                                  polyfit_kernel, quantile_kernel, unwrap_kernel)
from vistaf_torch.ops.consts import DeviceConsts
from torch_threads import single_torch_thread  # noqa: F401  (autouse)

SHAPES = [(8, 8), (59, 59), (118, 118), (236, 236), (240, 256), (295, 295), (296, 384),
          (300, 300), (489, 490), (591, 591), (400, 600), (100, 3000), (3000, 100),
          (1182, 1182), (1280, 1280), (1281, 1280), (1747, 1747)]

FITS = {
    "K1/K2": (quantile_kernel.fits, lambda s: j_quantile._fits_vmem(np.empty(s, np.float32))),
    "K3": (inpaint_kernel.fits, j_inpaint.fits_vmem),
    "K4": (ecc_kernel.fits, j_ecc.fits_vmem),
    "K5": (ecc_loop_kernel.fits, j_loop.fits_vmem_loop),
    "K6": (unwrap_kernel.fits, j_unwrap.fits_vmem),
    "K7": (polyfit_kernel.fits, j_polyfit.fits_vmem),
}


@pytest.mark.parametrize("kernel", sorted(FITS))
def test_fits_predicates_match_jax(kernel):
    ours, theirs = FITS[kernel]
    got = [ours(s) for s in SHAPES]
    assert got == [bool(theirs(s)) for s in SHAPES]
    assert any(got) and not all(got)


# ----------------------------------------------------------------------- K2
def _k2_case(name, rng):
    h, w = 37, 53
    x = rng.normal(size=(h, w)).astype(np.float32)
    m = rng.random((h, w)) > 0.3
    if name == "empty_mask":
        m[:] = False
    elif name == "all_nan":
        x[:] = np.nan
        m[:] = True
    elif name == "ties":
        x = rng.integers(0, 4, size=(h, w)).astype(np.float32)
    elif name == "single_element":
        m[:] = False
        m[5, 7] = True
    elif name == "nan_inside_mask":
        x[rng.random((h, w)) > 0.8] = np.nan
    elif name == "outliers":
        x[rng.random((h, w)) > 0.95] += 40.0
    return x, m


@pytest.mark.parametrize("case", ["random", "empty_mask", "all_nan", "ties",
                                  "single_element", "nan_inside_mask", "outliers"])
def test_k2_median_mad_bit_equal_to_pallas(case):
    x, m = _k2_case(case, np.random.default_rng(3))
    gold = j_quantile.masked_median_mad_pallas(jnp.asarray(x), jnp.asarray(m), refine=1,
                                               interpret=True)
    med, mad = quantile_kernel.masked_median_mad(torch.as_tensor(x), torch.as_tensor(m))
    assert med.shape == mad.shape == ()
    np.testing.assert_array_equal(np.array([med, mad]), np.asarray(gold, np.float32))


def test_k2_above_budget_route_is_the_jax_bisection_pair():
    """Above the budget both sides take the two bisection quantiles, whose
    MAD bracket is the masked range of |x - med| (not K2's)."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(1300, 1290)).astype(np.float32)
    x[rng.random(x.shape) > 0.97] += 6.0
    m = rng.random(x.shape) > 0.2
    assert not quantile_kernel.fits(x.shape)
    gold = j_quantile.masked_median_mad_pallas(jnp.asarray(x), jnp.asarray(m), refine=1)
    got = quantile_kernel.masked_median_mad(torch.as_tensor(x), torch.as_tensor(m))
    np.testing.assert_array_equal(np.array([float(v) for v in got]),
                                  np.asarray(gold, np.float32))


# ----------------------------------------------------------------------- K4
def _ecc_stack(rng, h, w, stride):
    I = rng.random((h, w)).astype(np.float32)
    gx = np.zeros_like(I)
    gx[:, 1:-1] = 0.5 * (I[:, 2:] - I[:, :-2])
    gy = np.zeros_like(I)
    gy[1:-1, :] = 0.5 * (I[2:, :] - I[:-2, :])
    M01 = (rng.random((h, w)) > 0.2).astype(np.float32)
    T = (rng.random((h, w)) - 0.5).astype(np.float32)
    sm = np.zeros((h, w), np.float32)
    sm[::stride, ::stride] = 1.0
    return np.stack([I, gx, gy, M01]), T, sm


@pytest.mark.parametrize("stride,K", [(1, 4), (2, 4), (2, 6)])
def test_k4_moments_match_pallas(stride, K):
    rng = np.random.default_rng(11)
    S, T, sm = _ecc_stack(rng, 100, 150, stride)
    p = np.array([0.003, 0.4, -0.7], np.float32)
    co_t = ecc_kernel.shear_coeffs(torch.as_tensor(p))
    c, s = np.cos(p[0]), np.sin(p[0])
    r = s / c
    co_j = jnp.asarray([r, c - r * (-s) - 1.0, p[2] - r * p[1], c - 1.0, -s, p[1], c, s],
                       jnp.float32)
    np.testing.assert_allclose(co_t.numpy(), np.asarray(co_j), rtol=1e-6, atol=1e-7)
    gold = np.asarray(j_ecc.gn_moments_euclidean(jnp.asarray(S), jnp.asarray(T),
                                                 jnp.asarray(sm), co_j, K=K,
                                                 interpret=True))
    ours = ecc_kernel.gn_moments_euclidean(torch.as_tensor(S), torch.as_tensor(T),
                                           torch.as_tensor(sm), co_t, K=K).numpy()
    assert ours.shape == (6, 6)
    np.testing.assert_array_equal(ours, ours.T)
    assert np.abs(ours - gold).max() <= 1e-5 * np.abs(gold).max()
    # and each entry within 1e-5 of its Cauchy-Schwarz scale sqrt(g_ii g_jj)
    d = np.sqrt(np.diag(gold).astype(np.float64))
    assert (np.abs(ours - gold) / np.outer(d, d)).max() <= 1e-5


def test_k4_moments_match_the_xla_shear_warp_product():
    """K4's rows are the plain shear sampler's: the moments equal A A^T of
    the JAX ``shear_warp_stack`` formulation (``tests/test_pallas_ecc.py``)."""
    rng = np.random.default_rng(12)
    S, T, sm = _ecc_stack(rng, 64, 90, 2)
    p = np.array([-0.004, -0.6, 0.9], np.float32)
    c, s = np.cos(p[0]), np.sin(p[0])
    samp = np.asarray(shear_warp_stack(jnp.asarray(S), jnp.asarray(
        np.array([[c, -s, p[1]], [s, c, p[2]]], np.float32)), K=4))
    mf = (samp[3] > 0.95).astype(np.float32) * sm
    vv, uu = np.mgrid[0:64, 0:90].astype(np.float32)
    gxm, gym = samp[1] * mf, samp[2] * mf
    A = np.stack([mf, T * mf, samp[0] * mf, gxm * (-s * uu - c * vv) + gym * (c * uu - s * vv),
                  gxm, gym]).reshape(6, -1).astype(np.float64)
    ours = ecc_kernel.gn_moments_euclidean(torch.as_tensor(S), torch.as_tensor(T),
                                           torch.as_tensor(sm),
                                           ecc_kernel.shear_coeffs(torch.as_tensor(p)))
    gold = A @ A.T
    assert np.abs(ours.numpy() - gold).max() <= 1e-5 * np.abs(gold).max()


# ----------------------------------------------------------------------- K6
def _phase_scene(rng, h, w, amp=9.0, holes=False):
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    k = np.exp(-0.5 * (np.arange(-36, 37) / 12.0) ** 2)
    k /= k.sum()
    noise = rng.standard_normal((h, w))
    smooth = np.apply_along_axis(lambda v: np.convolve(v, k, "same"), 0, noise)
    smooth = np.apply_along_axis(lambda v: np.convolve(v, k, "same"), 1, smooth)
    base = (smooth / smooth.std() * amp + 0.09 * xx + 0.05 * yy).astype(np.float32)
    mask = (yy - h / 2) ** 2 + (xx - w / 2) ** 2 <= (min(h, w) / 2 - 6) ** 2
    if holes:
        mask &= ~((yy - h / 3) ** 2 + (xx - w / 3) ** 2 <= 100)
        mask &= ~((np.abs(yy - 0.6 * h) < 3) & (xx > 0.5 * w))
    wrapped = np.angle(np.exp(1j * base)).astype(np.float32)
    return wrapped, mask


@pytest.mark.parametrize("shape,holes,iters,tol", [
    ((150, 210), False, 30, 1e-8),
    ((236, 236), True, 16, 1e-8),
    ((97, 130), True, 16, 1e-2),       # loose tol: the live mask stops early
    ((448, 384), True, 16, 1e-8),      # the largest plane of unwrap_kernel.fits
])
def test_k6_unwrap_matches_pallas(shape, holes, iters, tol):
    assert unwrap_kernel.fits(shape)
    wrapped, mask = _phase_scene(np.random.default_rng(5), *shape, holes=holes)
    gold = np.asarray(j_unwrap.unwrap_wls_pallas(jnp.asarray(wrapped), jnp.asarray(mask),
                                                 cg_iters=iters, tol=tol, interpret=True))
    ours = unwrap_kernel.unwrap_wls(torch.as_tensor(wrapped), torch.as_tensor(mask),
                                    DeviceConsts("cpu"), cg_iters=iters, tol=tol).numpy()
    np.testing.assert_array_equal(np.isnan(ours), ~mask)
    np.testing.assert_array_equal(np.isnan(ours), np.isnan(gold))
    same_k = np.abs(ours[mask] - gold[mask]) < 1e-3
    assert same_k.mean() >= 0.999, same_k.mean()


def test_k6_padded_domain_and_denominator():
    assert unwrap_kernel.padded_shape((236, 236)) == (240, 256)
    inv = unwrap_kernel.inv_poisson_denominator(240, 256)
    assert inv[0, 0] == 0.0 and np.isfinite(inv).all() and (inv[1:, :] < 0).all()
