"""The four kernels' plain PyTorch versions (the CPU route of each wrapper)
against the JAX Pallas kernels in interpret mode, as the JAX kernel tests
run them.  The same numpy inputs go to both sides.

Tolerances: K1 bit-equal (exact counts, the same f32 scalar arithmetic);
K3 atol 1e-5 on integer 0-255 data (the init mean is exact in any order,
the stencil is elementwise); K5 the JAX loop-kernel test's own bounds (rho
1e-4, theta 5e-5 rad, translations 5e-3 px, equal ``failed``); K7 rtol
1e-4 on the coefficients (plane sums in another order).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from vistaf_tpu.ops.inpaint import inpaint_diffusion_xla
from vistaf_tpu.pallas.ecc_loop_kernel import ecc_loop_euclidean as jax_ecc_loop
from vistaf_tpu.pallas.inpaint_kernel import inpaint_diffusion_pallas
from vistaf_tpu.pallas.polyfit_kernel import robust_polyfit2d_pallas
from vistaf_tpu.pallas.quantile_kernel import masked_quantiles_pallas

from vistaf_torch import kernels
from vistaf_torch.kernels.ecc_loop_kernel import ecc_loop_euclidean
from vistaf_torch.kernels.ecc_loop_kernel import fits as ecc_loop_kernel_fits
from vistaf_torch.kernels.inpaint_kernel import inpaint_diffusion
from vistaf_torch.kernels.polyfit_kernel import robust_polyfit2d_coef
from vistaf_torch.kernels.quantile_kernel import masked_quantiles
from torch_threads import single_torch_thread  # noqa: F401  (autouse)

QS = (0.0, 8.0, 25.0, 50.0, 92.0, 99.9, 100.0)


def _k1_case(name, rng):
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
    return x, m


@pytest.mark.parametrize("case", ["random", "empty_mask", "all_nan", "ties",
                                  "single_element", "nan_inside_mask"])
def test_k1_quantiles_bit_equal_to_pallas(case):
    x, m = _k1_case(case, np.random.default_rng(1))
    gold = np.asarray(masked_quantiles_pallas(jnp.asarray(x), jnp.asarray(m), QS,
                                              interpret=True))
    ours = masked_quantiles(torch.as_tensor(x), torch.as_tensor(m), QS).numpy()
    np.testing.assert_array_equal(ours, gold)


def test_k1_pair_batch_bit_equal_to_pallas():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 41, 47)).astype(np.float32)
    m = rng.random((41, 47)) > 0.25
    qs = (99.7, 25.0)
    f = jax.vmap(lambda a: masked_quantiles_pallas(a, jnp.asarray(m), qs, interpret=True))
    gold = np.asarray(f(jnp.asarray(x)))
    ours = masked_quantiles(torch.as_tensor(x), torch.as_tensor(m), qs)
    assert ours.shape == (2, 2)
    np.testing.assert_array_equal(ours.numpy(), gold)


@pytest.mark.parametrize("shape,iters,hole", [((100, 150), 24, None), ((37, 41), 20, None),
                                              ((64, 96), 6, (10, 54, 20, 80))],
                         ids=["shape0-24", "shape1-20", "wide_hole"])
def test_k3_inpaint_matches_pallas_and_xla(shape, iters, hole):
    """``hole``: rows and columns of a block of unknown pixels wider than
    2 * iters, whose centre keeps the initial mean (exact here: integer data
    whose sums stay below 2**24)."""
    rng = np.random.default_rng(7)
    img = np.round(rng.random(shape) * 255).astype(np.float32)
    fill = rng.random(shape) < 0.08
    if hole is not None:
        r0, r1, c0, c1 = hole
        fill[r0:r1, c0:c1] = True
    pallas = np.asarray(inpaint_diffusion_pallas(jnp.asarray(img), jnp.asarray(fill),
                                                 iters=iters, interpret=True))
    xla = np.asarray(inpaint_diffusion_xla(jnp.asarray(img), jnp.asarray(fill),
                                           iters=iters))
    ours = inpaint_diffusion(torch.as_tensor(img), torch.as_tensor(fill), iters).numpy()
    np.testing.assert_allclose(ours, pallas, rtol=0, atol=1e-5)
    np.testing.assert_allclose(ours, xla, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(ours[~fill], img[~fill])
    if hole is not None:
        centre = ours[r0 + iters + 1:r1 - iters - 1, c0 + iters + 1:c1 - iters - 1]
        mean0 = img[~fill].sum(dtype=np.float64) / (~fill).sum()
        np.testing.assert_allclose(centre, mean0, rtol=1e-6)


def test_k3_pair_batch_is_per_plane():
    rng = np.random.default_rng(9)
    img = np.round(rng.random((2, 30, 44)) * 255).astype(np.float32)
    fill = rng.random((2, 30, 44)) < 0.1
    both = inpaint_diffusion(torch.as_tensor(img), torch.as_tensor(fill), 12).numpy()
    for i in range(2):
        one = inpaint_diffusion(torch.as_tensor(img[i]), torch.as_tensor(fill[i]), 12)
        np.testing.assert_array_equal(both[i], one.numpy())


def _ecc_inputs(rng, th, tx, ty, h=96, w=130, invert=False):
    """Centred [I, gx, gy, mask] stack and template, as ecc_align builds them."""
    import cv2
    base = cv2.GaussianBlur(rng.random((h + 20, w + 20)).astype(np.float32), (0, 0), 3)
    c, s = np.cos(th), np.sin(th)
    M = np.array([[c, -s, tx], [s, c, ty]], np.float32)
    img = cv2.warpAffine(base, M, (w + 20, h + 20),
                         flags=cv2.INTER_LINEAR | cv2.WARP_INVERSE_MAP)
    T = base[10:-10, 10:-10].copy()
    I = img[10:-10, 10:-10].copy()
    if invert:
        I = (1.0 - I).astype(np.float32)
    mask = np.zeros((h, w), np.float32)
    cv2.circle(mask, (w // 2, h // 2), min(h, w) // 2 - 6, 1.0, -1)
    c0 = float((T * mask).sum() / max(mask.sum(), 1.0))
    Tc = (T - c0).astype(np.float32)
    Ic = (I - c0).astype(np.float32)
    gx = np.zeros_like(Ic)
    gx[:, 1:-1] = 0.5 * (Ic[:, 2:] - Ic[:, :-2])
    gy = np.zeros_like(Ic)
    gy[1:-1, :] = 0.5 * (Ic[2:, :] - Ic[:-2, :])
    return np.stack([Ic, gx, gy, mask]), Tc


ECC_CASES = {
    # name: (warp, ecc_loop kwargs)
    "converging": ((0.004, 0.9, -0.6), dict(max_iters=60, eps=1e-7)),
    "stall": ((0.002, 0.4, 0.3), dict(max_iters=200, eps=0.0, stall_patience=6)),
    "sts_no_conv": ((0.002, 0.3, -0.2), dict(max_iters=60, eps=1e-7, invert=True)),
    # the edge of the whole-solve budget: 352 x 256 pads to 90,112 of 90,416
    # elements, 360 x 256 (92,160) is above it
    "converging_352x256": ((0.004, 0.9, -0.6), dict(max_iters=60, eps=1e-7,
                                                    shape=(352, 256))),
}


@pytest.mark.parametrize("case", sorted(ECC_CASES))
def test_k5_ecc_loop_matches_pallas(case):
    (th, tx, ty), kw = ECC_CASES[case]
    kw = dict(kw)
    invert = kw.pop("invert", False)
    shape = kw.pop("shape", (96, 130))
    if shape != (96, 130):
        assert ecc_loop_kernel_fits(shape)
        assert not ecc_loop_kernel_fits((shape[0] + 8, shape[1]))
    S, T = _ecc_inputs(np.random.default_rng(0), th, tx, ty, *shape, invert=invert)
    sm = np.ones_like(T)
    sm[1::2, :] = 0.0   # a stride grid, as the slice's ecc_stride=2 builds
    jp, jrho, jit, jfail = jax_ecc_loop(jnp.asarray(S), jnp.asarray(T), jnp.asarray(sm),
                                        K=4, interpret=True, **kw)
    p, rho, it, failed = ecc_loop_euclidean(torch.as_tensor(S), torch.as_tensor(T),
                                            torch.as_tensor(sm), K=4, **kw)
    assert bool(failed) == bool(jfail)
    assert bool(failed) == (case == "sts_no_conv")
    if not bool(failed):
        assert abs(float(rho) - float(jrho)) < 1e-4
    assert abs(float(p[0]) - float(jp[0])) < 5e-5
    assert np.abs(p[1:].numpy() - np.asarray(jp[1:])).max() < 5e-3
    # Trip counts are reported, not compared: rho ~ 1 converges at the level
    # of one f32 ulp (eps 1e-7), so another summation order of the moment
    # sums stops the loop a few iterations earlier or later (PERF.md).
    print(f"{case}: iters port={int(it)} pallas={int(jit)}")
    assert 1 <= int(it) <= kw["max_iters"] and 1 <= int(jit) <= kw["max_iters"]
    if case == "stall":
        assert int(it) < 200 and int(jit) < 200


def _poly_scene(rng, h=150, w=210, outlier_frac=0.1):
    import cv2
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    xn = (xx - (w - 1) / 2) / ((w - 1) / 2)
    yn = (yy - (h - 1) / 2) / ((h - 1) / 2)
    truth = 0.8 * xn - 0.5 * yn + 0.2 + 0.6 * xn * xn - 0.3 * xn * yn + 0.1 * yn * yn
    z = truth + 0.02 * rng.standard_normal((h, w)).astype(np.float32)
    out = rng.random((h, w)) < outlier_frac
    z = np.where(out, z + 3.0 * rng.standard_normal((h, w)), z).astype(np.float32)
    mask = np.zeros((h, w), np.uint8)
    cv2.circle(mask, (w // 2, h // 2), min(h, w) // 2 - 6, 1, -1)
    z[5, 5] = np.nan
    return z, mask.astype(bool)


@pytest.mark.parametrize("order,iters,resigma", [(1, 6, 6), (2, 6, 6), (2, 4, 2)])
def test_k7_polyfit_matches_pallas(order, iters, resigma):
    z, m = _poly_scene(np.random.default_rng(0))
    gold, _ = robust_polyfit2d_pallas(jnp.asarray(z), jnp.asarray(m), order=order,
                                      iters=iters, resigma_iters=resigma, interpret=True)
    ours = robust_polyfit2d_coef(torch.as_tensor(z), torch.as_tensor(m), order=order,
                                 iters=iters, resigma_iters=resigma).numpy()
    assert ours.shape == (3 if order == 1 else 6,)
    np.testing.assert_allclose(ours, np.asarray(gold), rtol=1e-4, atol=0)


def test_k7_degenerate_mask_gives_zeros():
    z, _ = _poly_scene(np.random.default_rng(0))
    tiny = np.zeros_like(z, dtype=bool)
    tiny[10:20, 10:29] = True          # 190 px < 200
    gold, _ = robust_polyfit2d_pallas(jnp.asarray(z), jnp.asarray(tiny), order=2,
                                      iters=4, resigma_iters=2, interpret=True)
    ours = robust_polyfit2d_coef(torch.as_tensor(z), torch.as_tensor(tiny), order=2,
                                 iters=4, resigma_iters=2).numpy()
    assert np.abs(np.asarray(gold)).max() == 0.0
    np.testing.assert_array_equal(ours, np.zeros(6, np.float32))


def test_cpu_route_launches_no_kernel_and_other_devices_raise():
    kernels.reset_launches()
    x = torch.zeros((8, 8))
    masked_quantiles(x, x > 1, (50.0,))
    inpaint_diffusion(x, x > 1, 2)
    assert all(v == 0 for v in kernels.LAUNCHES.values())
    with pytest.raises(ValueError, match="device"):
        masked_quantiles(x.to("meta"), (x > 1).to("meta"), (50.0,))
