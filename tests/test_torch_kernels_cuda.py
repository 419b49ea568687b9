"""The eight Hopper kernels and the labelling kernel against their plain
PyTorch versions on the card, the 640x480 force slice and a small
temperature frame on the card against the port's CPU run, the CUDA-graph
conditional nodes (a WHILE and an IF node against their host forms), and
the slice's CUDA-graph replay (deploy and parity) against its forward run
op by op.  Marked ``cuda``:
they skip where PyTorch sees no GPU (the decision is made in a fixture, not
at import).  Run on a GPU machine with

    python -m pytest tests/test_torch_kernels_cuda.py -q -m cuda

Tolerances as in test_torch_kernels.py; ``chip_smoke.py`` runs the same
comparisons at the slice's shapes and times them.
"""
import numpy as np
import pytest
import torch

from vistaf_torch import kernels
from vistaf_torch.kernels import ccl_kernel
from vistaf_torch.kernels import ecc_kernel as k4
from vistaf_torch.kernels import ecc_loop_kernel as k5
from vistaf_torch.kernels import inpaint_kernel as k3
from vistaf_torch.kernels import polyfit_kernel as k7
from vistaf_torch.kernels import quantile_kernel as k1
from vistaf_torch.kernels import temp_kernel as k8
from vistaf_torch.kernels import unwrap_kernel as k6

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU mode)")
    from vistaf_torch import use_full_fp32
    use_full_fp32()
    kernels.library()
    return torch.device("cuda", 0)


def _disk(h, w, r):
    yy, xx = np.mgrid[0:h, 0:w]
    return (yy - h // 2) ** 2 + (xx - w // 2) ** 2 <= r * r


@pytest.mark.parametrize("n", [236, 1182])     # the 640 and native-4K crops
def test_k1_bit_equal_on_card(dev, n):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, n, n)).astype(np.float32)
    x[:, 5:9, 5:9] = np.nan
    m = torch.as_tensor(_disk(n, n, n // 2 - 1), device=dev)
    xt = torch.as_tensor(x, device=dev)
    for qs in ((99.9,), (92.0, 95.0, 98.0), (0.0, 50.0, 100.0)):
        assert torch.equal(k1.masked_quantiles(xt, m, qs),
                           k1.masked_quantiles_plain(xt, m, qs))
    empty = torch.zeros_like(m)
    assert torch.equal(k1.masked_quantiles(xt, empty, (50.0,)),
                       torch.zeros((2, 1), device=dev))


@pytest.mark.parametrize("n", [236, 1182])     # the 640 and native-4K crops
def test_k3_matches_plain_on_card(dev, n):
    rng = np.random.default_rng(1)
    img = torch.as_tensor(np.round(rng.random((2, n, n)) * 255).astype(np.float32),
                          device=dev)
    fill = torch.as_tensor(rng.random((2, n, n)) < 0.05, device=dev)
    got = k3.inpaint_diffusion(img, fill, 20)
    want = k3.inpaint_diffusion_plain(img, fill, 20)
    assert float((got - want).abs().max()) <= 1e-5


# Shapes where the multi-CTA K1 can go wrong: (planes shape, mask density,
# quantiles, levels).  The ladder takes 8 levels a pass; the CTAs split a
# plane into chunks of a multiple of 4 elements, with 16-byte loads only
# where the plane's length is a multiple of 4.
K1_CASES = {
    "row_1xn": ((1, 5003), 0.7, (25.0, 50.0, 98.0), k1.LEVELS),
    "column_nx1": ((4097, 1), 0.7, (25.0, 50.0, 98.0), k1.LEVELS),
    "ragged_length": ((301, 211), 0.8, (5.0, 92.0), k1.LEVELS),
    "batch_of_3": ((3, 90, 130), 0.6, (50.0, 99.7), k1.LEVELS),
    "levels_16": ((2, 236, 236), 0.9, (50.0,), k1.MAD_LEVELS),
    "levels_7": ((2, 64, 96), 0.9, (10.0, 90.0), 7),
    "levels_0": ((2, 64, 96), 0.9, (10.0, 90.0), 0),
    "eight_quantiles": ((2, 300, 256), 0.9,
                        (0.0, 1.0, 12.5, 25.0, 50.0, 75.0, 99.9, 100.0), k1.LEVELS),
    "integer_ties": ((1, 1000, 1024), 0.95, (25.0, 50.0, 75.0), k1.LEVELS),
    "zeros_and_denormals": ((2, 64, 96), 0.9, (1.0, 50.0, 99.0), k1.LEVELS),
    "overflow_inside_tree": ((2, 64, 96), 1.0, (10.0, 50.0, 90.0), k1.LEVELS),
}


@pytest.mark.parametrize("case", sorted(K1_CASES))
def test_k1_shapes_bit_equal_on_card(dev, case):
    shape, density, qs, levels = K1_CASES[case]
    rng = np.random.default_rng(10)
    if case == "integer_ties":
        x = rng.integers(0, 4, size=shape).astype(np.float32)
    elif case == "zeros_and_denormals":
        x = rng.choice(np.array([-0.0, 0.0, 1e-45, -1e-45, 3e-42, -7e-40, 1e-38],
                                np.float32), size=shape)
    elif case == "overflow_inside_tree":   # lo + hi fits, a child's sum overflows
        x = rng.uniform(0.5e38, 2.3e38, size=shape).astype(np.float32)
    else:
        x = rng.normal(size=shape).astype(np.float32)
        x[rng.random(shape) > 0.99] = np.nan
    m = torch.as_tensor(rng.random(shape) < density, device=dev)
    xt = torch.as_tensor(x, device=dev)
    kernels.reset_launches()
    got = k1.masked_quantiles(xt, m, qs, levels=levels)
    assert kernels.LAUNCHES["masked_quantiles"] == 1
    want = k1.masked_quantiles_plain(xt, m, qs, levels=levels)
    assert got.shape == want.shape == (*shape[:-2], len(qs))
    assert torch.equal(got.view(torch.int32), want.view(torch.int32)), (got, want)


# (planes shape, iterations, share of unknown pixels); K3 runs kHalo = 4
# steps a launch on 32 x 64 tiles
K3_CASES = {
    "smaller_than_tile": ((2, 20, 30), 20, 0.1),
    "ragged_sides": ((1, 130, 197), 6, 0.05),
    "iters_0": ((1, 70, 150), 0, 0.1),
    "iters_1": ((1, 70, 150), 1, 0.1),
    "iters_3": ((1, 70, 150), 3, 0.1),
    "iters_5": ((1, 70, 150), 5, 0.1),
    "iters_20": ((2, 70, 150), 20, 0.3),
    "no_known_pixel": ((1, 70, 150), 8, 1.0),
}


@pytest.mark.parametrize("case", sorted(K3_CASES))
def test_k3_shapes_match_plain_on_card(dev, case):
    shape, iters, share = K3_CASES[case]
    rng = np.random.default_rng(11)
    img = torch.as_tensor(np.round(rng.random(shape) * 255).astype(np.float32), device=dev)
    fill = torch.as_tensor(rng.random(shape) < share if share < 1.0
                           else np.ones(shape, bool), device=dev)
    kernels.reset_launches()
    got = k3.inpaint_diffusion(img, fill, iters)
    assert kernels.LAUNCHES["inpaint_diffusion"] == 1
    want = k3.inpaint_diffusion_plain(img, fill, iters)
    assert float((got - want).abs().max()) <= 1e-5


def test_k3_wide_hole_mean_on_card(dev):
    """A hole wider than 2 * iters: its centre keeps the initial mean, whose
    fixed-order sum may round differently from torch.sum's (relative 1e-6);
    every pixel a step reaches stays within 1e-5."""
    rng = np.random.default_rng(12)
    h, w, iters = 600, 800, 20
    img = torch.as_tensor((rng.random((h, w)) * 255).astype(np.float32), device=dev)
    fill = np.zeros((h, w), bool)
    fill[150:450, 200:600] = True
    far = np.zeros((h, w), bool)
    far[150 + iters:450 - iters, 200 + iters:600 - iters] = True
    fill_t = torch.as_tensor(fill, device=dev)
    far_t = torch.as_tensor(far, device=dev)
    got = k3.inpaint_diffusion(img, fill_t, iters)
    want = k3.inpaint_diffusion_plain(img, fill_t, iters)
    mean0 = float(want[far_t][0])
    assert torch.all(want[far_t] == mean0)
    assert float((got[far_t] - mean0).abs().max()) <= 1e-6 * abs(mean0)
    assert float((got[~far_t] - want[~far_t]).abs().max()) <= 1e-5


def _k5_inputs(dev, h, w, invert=False):
    """A smooth template and its shifted, rotated copy, prepared as
    ``ecc_align`` prepares them, over a disk with a stride-2 statistics grid;
    ``invert`` flips the image's contrast (StsNoConv)."""
    from vistaf_torch.ops.consts import DeviceConsts
    from vistaf_torch.ops.filters import gaussian_blur
    from vistaf_torch.ops.registration import ecc_prepare
    from vistaf_torch.ops.warp import warp_affine_inverse_shear
    rng = np.random.default_rng(2)
    base = gaussian_blur(torch.as_tensor(rng.random((h, w)).astype(np.float32), device=dev),
                         3.0, DeviceConsts(dev))
    th, tx, ty = 0.002, -0.7, 0.5
    M = torch.tensor([[np.cos(th), -np.sin(th), tx], [np.sin(th), np.cos(th), ty]],
                     dtype=torch.float32, device=dev)
    moved = warp_affine_inverse_shear(base, M, K=4)
    S, T = ecc_prepare(base, moved, torch.as_tensor(_disk(h, w, min(h, w) // 2 - 2),
                                                    device=dev))
    if invert:
        S = S.clone()
        S[:3] *= -1.0
    sm = torch.zeros_like(T)
    sm[::2, ::2] = 1.0
    return S, T, sm


# (K, max_iters, eps, stall_patience, inverted image) of each case
K5_CASES = {
    "converging": (4, 300, 1e-7, 0, False),
    "stall": (4, 200, 0.0, 6, False),
    "sts_no_conv": (4, 300, 1e-7, 25, True),
}


# the 640 crop and two shapes at the edge of ecc_loop_kernel.fits
@pytest.mark.parametrize("shape", [(236, 236), (352, 256), (232, 384)])
@pytest.mark.parametrize("case", sorted(K5_CASES))
def test_k5_matches_plain_on_card(dev, case, shape):
    K, max_iters, eps, patience, invert = K5_CASES[case]
    assert k5.fits(shape)
    S, T, sm = _k5_inputs(dev, *shape, invert=invert)
    kernels.reset_launches()
    pa, ra, ia, fa = k5.ecc_loop_euclidean(S, T, sm, K, max_iters, eps, patience)
    assert kernels.LAUNCHES["ecc_loop_euclidean"] == 1
    pb, rb, ib, fb = k5.ecc_loop_euclidean_plain(S, T, sm, K, max_iters, eps, patience)
    assert bool(fa) == bool(fb) == invert
    if not invert:
        assert abs(float(ra) - float(rb)) < 1e-4
    assert float((pa[0] - pb[0]).abs()) < 5e-5
    assert float((pa[1:] - pb[1:]).abs().max()) < 5e-3
    assert 1 <= int(ia) <= max_iters
    if case == "stall":
        assert int(ia) < max_iters


def test_k5_same_bits_twice_on_card(dev):
    S, T, sm = _k5_inputs(dev, 352, 256)
    a = k5.ecc_loop_euclidean(S, T, sm, 4, 300, 1e-7, 0)
    b = k5.ecc_loop_euclidean(S, T, sm, 4, 300, 1e-7, 0)
    for x, y in zip(a, b):
        assert torch.equal(x, y), (a, b)


def test_k5_raises_above_budget_on_card(dev):
    S, T, sm = (torch.zeros((4, 360, 256), device=dev), torch.zeros((360, 256), device=dev),
                torch.ones((360, 256), device=dev))
    assert not k5.fits(T.shape)
    kernels.reset_launches()
    with pytest.raises(ValueError):
        k5.ecc_loop_euclidean(S, T, sm, 4, 300, 1e-7, 0)
    assert kernels.LAUNCHES["ecc_loop_euclidean"] == 0


def _k7_close(got, want):
    """Within 1e-4 of the largest coefficient: the kernel sums in another
    order than the plain version (exact zeros stay exact)."""
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max()), (got, want)


def _k7_plane(h, w, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32) / max(h, w)
    z = (0.5 * xx - 0.3 * yy + 0.4 * xx * xx + 0.01 * rng.standard_normal((h, w))
         ).astype(np.float32)
    z[rng.random((h, w)) < 0.05] += 3.0
    return z, rng


@pytest.mark.parametrize("order", [1, 2])
def test_k7_matches_plain_on_card(dev, order):
    z, _ = _k7_plane(236, 236, 3)
    zt = torch.as_tensor(z, device=dev)
    m = torch.as_tensor(_disk(236, 236, 110), device=dev)
    kernels.reset_launches()
    got = k7.robust_polyfit2d_coef(zt, m, order, 4, 4.685, 2)
    assert kernels.LAUNCHES["robust_polyfit2d"] == 1
    _k7_close(got, k7.robust_polyfit2d_coef_plain(zt, m, order, 4, 4.685, 2))


# (plane shape, order, iters, resigma_iters, mask kind): the largest plane
# the budget admits (584 x 512 pads to 299,008 of 300,000 elements, 146 KB
# a CTA), a row length that is not a multiple of 4 (scalar loads), and the
# edge cases of the fit
K7_CASES = {
    "largest_plane": ((584, 512), 2, 4, 2, "disk"),
    "largest_plane_order_1": ((584, 512), 1, 4, 2, "disk"),
    "ragged_row": ((201, 237), 2, 4, 2, "disk"),
    "order_1_six_rounds": ((236, 236), 1, 6, 6, "disk"),
    "iters_0": ((236, 236), 2, 0, 2, "disk"),
    "iters_1_weights_1": ((236, 236), 2, 1, 1, "disk"),
    "resigma_above_iters": ((236, 236), 2, 3, 6, "disk"),
    "nan_inf_inside_mask": ((236, 236), 2, 4, 2, "nan_inf"),
    "under_200_valid": ((236, 236), 2, 4, 2, "tiny"),
    "empty_mask": ((236, 236), 2, 4, 2, "empty"),
}


@pytest.mark.parametrize("case", sorted(K7_CASES))
def test_k7_cases_match_plain_on_card(dev, case):
    (h, w), order, iters, resigma, kind = K7_CASES[case]
    z, rng = _k7_plane(h, w, 13)
    m = _disk(h, w, min(h, w) // 2 - 8)
    if kind == "nan_inf":
        z[rng.random((h, w)) < 0.01] = np.nan
        z[h // 2, w // 2 - 3:w // 2] = (np.inf, -np.inf, np.nan)
    elif kind == "tiny":
        m = _disk(h, w, 7)                  # 149 pixels
        assert m.sum() < 200
    elif kind == "empty":
        m[:] = False
    zt, mt = torch.as_tensor(z, device=dev), torch.as_tensor(m, device=dev)
    assert k7.fits((h, w))
    kernels.reset_launches()
    got = k7.robust_polyfit2d_coef(zt, mt, order, iters, 4.685, resigma)
    assert kernels.LAUNCHES["robust_polyfit2d"] == 1
    want = k7.robust_polyfit2d_coef_plain(zt, mt, order, iters, 4.685, resigma)
    _k7_close(got, want)
    if kind in ("tiny", "empty") or iters == 0:
        assert torch.equal(got, torch.zeros_like(got))


def test_k7_same_bits_twice_on_card(dev):
    z, _ = _k7_plane(584, 512, 14)
    zt = torch.as_tensor(z, device=dev)
    m = torch.as_tensor(_disk(584, 512, 250), device=dev)
    a = k7.robust_polyfit2d_coef(zt, m, 2, 4, 4.685, 2)
    b = k7.robust_polyfit2d_coef(zt, m, 2, 4, 4.685, 2)
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_k7_raises_above_budget_on_card(dev):
    z = torch.zeros((600, 512), device=dev)       # pads to 307,200 > 300,000
    assert not k7.fits(z.shape)
    kernels.reset_launches()
    with pytest.raises(ValueError):
        k7.robust_polyfit2d_coef(z, torch.ones_like(z, dtype=torch.bool), 2, 4, 4.685, 2)
    assert kernels.LAUNCHES["robust_polyfit2d"] == 0


def test_k2_bit_equal_on_card(dev):
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 300, 310)).astype(np.float32)
    x[:, rng.random((300, 310)) > 0.97] += 8.0
    x[:, 5:9, 5:9] = np.nan
    xt = torch.as_tensor(x, device=dev)
    m = torch.as_tensor(_disk(300, 310, 140), device=dev)
    for a, b in zip(k1.masked_median_mad(xt, m), k1.masked_median_mad_plain(xt, m)):
        assert a.shape == (2,) and torch.equal(a, b)


# Shapes where K2 on the ladder can go wrong: (planes shape, mask kind).
# 1 x n and n x 1 planes, a length that is not a multiple of 4 (scalar
# loads), planes of a batch with different masks, an empty mask, a single
# valid pixel, and a MAD bracket whose top overflows to +inf
K2_CASES = {
    "row_1xn": ((1, 5003), "random"),
    "column_nx1": ((4097, 1), "random"),
    "ragged_length": ((301, 211), "random"),
    "batch_of_2_masks": ((2, 300, 310), "per_plane"),
    "native_4k_crop": ((1182, 1182), "random"),
    "empty_mask": ((300, 310), "empty"),
    "single_pixel": ((300, 310), "single"),
    "span_overflow": ((300, 310), "random"),
}


@pytest.mark.parametrize("case", sorted(K2_CASES))
def test_k2_shapes_bit_equal_on_card(dev, case):
    shape, kind = K2_CASES[case]
    rng = np.random.default_rng(15)
    x = rng.normal(size=shape).astype(np.float32)
    x[rng.random(shape) > 0.97] += 6.0
    x[rng.random(shape) > 0.995] = np.nan
    if case == "span_overflow":            # med near -3e38, x near +3e38
        x = -rng.uniform(2.9e38, 3.4e38, size=shape).astype(np.float32)
        x[rng.random(shape) > 0.8] *= -1.0
    m = rng.random(shape) < 0.8
    if kind == "per_plane":
        m[1] = rng.random(shape[1:]) < 0.3
    elif kind == "empty":
        m[:] = False
    elif kind == "single":
        m[:] = False
        m[7, 9] = True
    xt, mt = torch.as_tensor(x, device=dev), torch.as_tensor(m, device=dev)
    assert k1.fits(shape)
    kernels.reset_launches()
    got = k1.masked_median_mad(xt, mt)
    assert kernels.LAUNCHES["masked_median_mad"] == 1
    want = k1.masked_median_mad_plain(xt, mt)
    for a, b in zip(got, want):
        assert a.shape == b.shape == shape[:-2]
        assert torch.equal(a.view(torch.int32), b.view(torch.int32)), (got, want)
    if kind == "empty":
        assert not torch.any(got[0]) and not torch.any(got[1])


def test_k2_same_bits_twice_on_card(dev):
    rng = np.random.default_rng(16)
    xt = torch.as_tensor(rng.normal(size=(1182, 1182)).astype(np.float32), device=dev)
    mt = torch.as_tensor(_disk(1182, 1182, 580), device=dev)
    a = k1.masked_median_mad(xt, mt)
    b = k1.masked_median_mad(xt, mt)
    for u, v in zip(a, b):
        assert torch.equal(u.view(torch.int32), v.view(torch.int32))


def test_k2_above_budget_launches_k1_on_card(dev):
    """Above K2's budget the bisection pair runs as two K1 launches, bit-equal
    to its plain version on the CPU."""
    rng = np.random.default_rng(7)
    x = rng.normal(size=(1300, 1290)).astype(np.float32)
    x[rng.random(x.shape) > 0.97] += 6.0
    m = rng.random(x.shape) > 0.2
    assert not k1.fits(x.shape)
    kernels.reset_launches()
    got = k1.masked_median_mad(torch.as_tensor(x, device=dev), torch.as_tensor(m, device=dev))
    assert kernels.LAUNCHES["masked_quantiles"] == 2
    assert kernels.LAUNCHES["masked_median_mad"] == 0
    want = k1.masked_median_mad(torch.as_tensor(x), torch.as_tensor(m))
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)


def test_k4_matches_plain_on_card(dev):
    rng = np.random.default_rng(5)
    S = torch.as_tensor(rng.random((4, 295, 295)).astype(np.float32), device=dev)
    S[3] = (S[3] > 0.2).float()
    T = torch.as_tensor(rng.random((295, 295)).astype(np.float32) - 0.5, device=dev)
    sm = torch.zeros_like(T)
    sm[::2, ::2] = 1.0
    co = k4.shear_coeffs(torch.tensor([0.003, 0.4, -0.7], device=dev))
    got = k4.gn_moments_euclidean(S, T, sm, co, K=4)
    want = k4.gn_moments_euclidean_plain(S, T, sm, co, K=4)
    # each entry within 1e-5 of its Cauchy-Schwarz scale sqrt(b_ii b_jj)
    d = torch.sqrt(want.diagonal())
    assert float(((got - want).abs() / torch.outer(d, d)).max()) <= 1e-5
    assert torch.equal(got, k4.gn_moments_euclidean(S, T, sm, co, K=4))   # fixed order


# (shape, seed) of K4's loop: the native-4K coarse grid unseeded and seeded
# near the warp, and a wide plane at the edge of ecc_kernel.fits (97 x 1920
# pads to 199,680 of 200,000 elements: tiles split its columns)
K4_LOOP_CASES = {
    "coarse_295": ((295, 295), None),
    "coarse_295_seeded": ((295, 295), (0.0015, -0.5, 0.4)),
    "wide_97x1920": ((97, 1920), None),
}


@pytest.mark.parametrize("case", sorted(K4_LOOP_CASES))
def test_k4_loop_matches_plain_on_card(dev, case):
    shape, seed = K4_LOOP_CASES[case]
    assert k4.fits(shape)
    S, T, sm = _k5_inputs(dev, *shape)
    p0 = torch.tensor(seed or (0.0, 0.0, 0.0), dtype=torch.float32, device=dev)
    kernels.reset_launches()
    pa, ra, ia, fa = k4.gn_loop_euclidean(S, T, sm, p0, 4, 300, 1e-7, 25)
    assert kernels.LAUNCHES["gn_moments_euclidean"] == 1
    pb, rb, ib, fb = k4.gn_loop_euclidean_plain(S, T, sm, p0, 4, 300, 1e-7, 25)
    assert not bool(fa) and not bool(fb)
    assert abs(float(ra) - float(rb)) < 1e-4
    assert float((pa[0] - pb[0]).abs()) < 5e-5
    assert float((pa[1:] - pb[1:]).abs().max()) < 5e-3
    assert 1 <= int(ia) <= 300


def test_k4_loop_same_bits_twice_on_card(dev):
    S, T, sm = _k5_inputs(dev, 295, 295)
    for seed in ((0.0, 0.0, 0.0), (0.0015, -0.5, 0.4)):
        p0 = torch.tensor(seed, dtype=torch.float32, device=dev)
        a = k4.gn_loop_euclidean(S, T, sm, p0, 4, 300, 1e-7, 25)
        b = k4.gn_loop_euclidean(S, T, sm, p0, 4, 300, 1e-7, 25)
        for x, y in zip(a, b):
            assert torch.equal(x, y), (a, b)


def test_k4_loop_sts_no_conv_on_card(dev):
    """An inverted image fails (StsNoConv) on both sides."""
    S, T, sm = _k5_inputs(dev, 295, 295, invert=True)
    p0 = torch.zeros(3, device=dev)
    a = k4.gn_loop_euclidean(S, T, sm, p0, 4, 300, 1e-7, 25)
    b = k4.gn_loop_euclidean_plain(S, T, sm, p0, 4, 300, 1e-7, 25)
    assert bool(a[3]) and bool(b[3])
    assert torch.equal(a[0], b[0])                  # the seed, unchanged


def test_k4_tile_layout_agrees_on_card(dev):
    """The C launcher's shared-memory size of a tiling is the planner's."""
    lib = kernels.library()
    for h, w, K in ((295, 295, 4), (97, 1920, 4), (8, 24960, 4), (300, 600, 6), (1, 1, 0)):
        nr, nc = k4.tile_plan(h, w, K, torch.cuda.get_device_properties(dev).multi_processor_count)
        assert lib.vt_gn_loop_smem_bytes(h, w, K, nr, nc) == k4.tile_bytes(h, w, K, nr, nc)


def test_k4_raises_above_budget_on_card(dev):
    S, T, sm = (torch.zeros((4, 420, 470), device=dev), torch.zeros((420, 470), device=dev),
                torch.ones((420, 470), device=dev))
    assert not k4.fits(T.shape)
    kernels.reset_launches()
    with pytest.raises(ValueError):
        k4.gn_loop_euclidean(S, T, sm, torch.zeros(3, device=dev), 4, 300, 1e-7, 0)
    assert kernels.LAUNCHES["gn_moments_euclidean"] == 0


def _phase_scene(h, w, holes, seed=6):
    """Wrapped phase of a smooth random field with a ramp, over a disk
    (with a round hole and a cut when ``holes``)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    k = np.exp(-0.5 * (np.arange(-36, 37) / 12.0) ** 2)
    k /= k.sum()
    smooth = np.apply_along_axis(lambda v: np.convolve(v, k, "same"), 0,
                                 rng.standard_normal((h, w)))
    smooth = np.apply_along_axis(lambda v: np.convolve(v, k, "same"), 1, smooth)
    field = smooth / smooth.std() * 9.0 + 0.09 * xx + 0.05 * yy
    mask = (yy - h / 2) ** 2 + (xx - w / 2) ** 2 <= (min(h, w) / 2 - 6) ** 2
    if holes:
        mask &= ~((yy - h / 3) ** 2 + (xx - w / 3) ** 2 <= 100)
        mask &= ~((np.abs(yy - 0.6 * h) < 3) & (xx > 0.5 * w))
    return np.angle(np.exp(1j * field)).astype(np.float32), mask


# (shape, holes, cg_iters, tol): the 640 crop with holes, the largest plane
# of unwrap_kernel.fits, and a loose tol under which `live` stops early
K6_CASES = {
    "crop_236_holes": ((236, 236), True, 16, 1e-8),
    "largest_448x384": ((448, 384), True, 16, 1e-8),
    "loose_tol": ((236, 236), True, 16, 1e-2),
}


@pytest.mark.parametrize("case", sorted(K6_CASES))
def test_k6_matches_plain_on_card(dev, case):
    shape, holes, iters, tol = K6_CASES[case]
    assert k6.fits(shape)
    wrapped, mask = _phase_scene(*shape, holes)
    wrapped, mask = torch.as_tensor(wrapped, device=dev), torch.as_tensor(mask, device=dev)
    from vistaf_torch.ops.consts import DeviceConsts
    consts = DeviceConsts(dev)
    kernels.reset_launches()
    got = k6.unwrap_wls(wrapped, mask, consts, iters, tol)
    assert kernels.LAUNCHES["unwrap_wls"] == 1
    want = k6.unwrap_wls_plain(wrapped, mask, consts, iters, tol)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.equal(torch.isnan(got), ~mask)
    same_k = (got[mask] - want[mask]).abs() < 1e-3
    assert float(same_k.float().mean()) >= 0.999


def test_k6_same_bits_twice_on_card(dev):
    wrapped, mask = _phase_scene(448, 384, True)
    wrapped, mask = torch.as_tensor(wrapped, device=dev), torch.as_tensor(mask, device=dev)
    from vistaf_torch.ops.consts import DeviceConsts
    consts = DeviceConsts(dev)
    a = k6.unwrap_wls(wrapped, mask, consts, 16, 1e-8)
    b = k6.unwrap_wls(wrapped, mask, consts, 16, 1e-8)
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_k6_raises_above_budget_on_card(dev):
    wrapped = torch.zeros((600, 512), device=dev)     # pads to 307,200 > 240,000
    assert not k6.fits(wrapped.shape)
    from vistaf_torch.ops.consts import DeviceConsts
    kernels.reset_launches()
    with pytest.raises(ValueError):
        k6.unwrap_wls(wrapped, torch.ones_like(wrapped, dtype=torch.bool),
                      DeviceConsts(dev), 16, 1e-8)
    assert kernels.LAUNCHES["unwrap_wls"] == 0


def test_slice_on_card_launches_every_kernel(dev):
    from vistaf_torch.config import ForceConfig, slice_ftp_config
    from vistaf_torch.pipelines.force import ForcePipeline
    from vistaf_torch.utils.synthetic import synthetic_pair
    p2h = {"type": "hinge_saturating",
           "params": {"a": 2.0826494996246554, "b": 4.20441143052732,
                      "c": -1.767844217125454e-09}}
    fm = {"type": "growth", "params": {"a": 1.6197727931063521, "b": 9.756634595755994}}
    cfg = slice_ftp_config(480, 640)
    ref, de = synthetic_pair(480, 640, cfg)
    kernels.reset_launches()
    gpu = ForcePipeline(cfg, ForceConfig(), p2h, fm, device=dev)(ref, de)
    for name in ("masked_quantiles", "inpaint_diffusion", "ecc_loop_euclidean",
                 "unwrap_wls", "robust_polyfit2d", "label_components"):
        assert kernels.LAUNCHES[name] > 0, kernels.LAUNCHES
    cpu = ForcePipeline(cfg, ForceConfig(), p2h, fm, device="cpu")(ref, de)
    assert abs(gpu["force_N"] - cpu["force_N"]) <= 0.01 * cpu["force_N"]


@pytest.mark.parametrize("n", [236, 1182])     # the 640 and native-4K crops
@pytest.mark.parametrize("kind", ["random", "spiral"])
def test_labels_bit_equal_on_card(dev, n, kind):
    from chip_smoke import spiral_mask
    m = (np.random.default_rng(n).random((n, n)) < 0.5 if kind == "random"
         else spiral_mask(n, n))
    mt = torch.as_tensor(m, device=dev)
    kernels.reset_launches()
    got = ccl_kernel.label_components(mt)
    assert kernels.LAUNCHES["label_components"] == 1
    assert torch.equal(got, ccl_kernel.label_components_plain(mt))


def test_graph_replay_equals_eager_on_card(dev):
    """The 640 deploy forward replayed from its CUDA graph against the same
    forward op by op, on two frame pairs after the capture call: every
    output bit for bit, and each replay counting the captured launches."""
    from vistaf_torch.config import slice_ftp_config
    from vistaf_torch.ftp.pipeline import FTPPipeline
    from vistaf_torch.utils.synthetic import synthetic_pair
    p2h = {"type": "hinge_saturating", "params": {"a": 2.08, "b": 4.2, "c": 0.0}}
    cfg = slice_ftp_config(480, 640)
    pipe = FTPPipeline(cfg, p2h, device=dev)
    assert pipe.graph_route()
    pairs = [[torch.as_tensor(f, device=dev) for f in synthetic_pair(480, 640, cfg, seed=s)]
             for s in range(3)]
    pipe.forward(*pairs[0])                       # eager, then the capture
    for r, d in pairs[1:]:
        kernels.reset_launches()
        got = pipe.forward(r, d)
        assert dict(kernels.LAUNCHES) == {**dict.fromkeys(kernels.LAUNCHES, 0),
                                          **pipe._graph.launches}
        want = pipe.forward_eager(r, d)
        for k in want:
            a, b = got[k], want[k]
            if a.is_floating_point():
                assert torch.equal(torch.isnan(a), torch.isnan(b)), k
                a, b = torch.nan_to_num(a), torch.nan_to_num(b)
            assert torch.equal(a, b), k
    with pytest.raises(ValueError):
        pipe.forward(pairs[0][0][:240], pairs[0][1][:240])


def _captured(dev, fn):
    """``fn`` captured once into a CUDA graph that may hold conditional
    nodes; returns the graph and the pool its bodies allocate from."""
    from vistaf_torch.utils import cuda_graph
    g = torch.cuda.CUDAGraph()
    with cuda_graph.conditional_bodies(dev) as pool, \
            torch.cuda.graph(g, capture_error_mode="thread_local"):
        fn()
    return g, pool


def test_while_node_trip_counts_equal_the_host_loop(dev):
    """A WHILE node (``device_while`` under a capture) counting up to a
    device limit under a cap of 9, its body adding a vector each trip: trip
    counts 0, 1, N and the cap equal to the plain loop's, the sums bit-equal,
    and the condition setter run once more than the trips: the trips in
    the site's slot, the first set in ``entry``."""
    from vistaf_torch.kernels import graph_cond_kernel
    from vistaf_torch.utils.cuda_graph import device_while
    limit = torch.zeros((), dtype=torch.int32, device=dev)
    it = torch.zeros((), dtype=torch.int32, device=dev)
    acc = torch.zeros(5, device=dev)
    x = torch.linspace(0.1, 0.5, 5, device=dev)

    def loop():
        it.zero_()
        acc.zero_()
        device_while(lambda s: (s[0] < limit) & (s[0] < 9),
                     lambda s: (s[1].add_(x * 1.5), s[0].add_(1)), (it, acc), site="pcg")
    g, pool = _captured(dev, loop)     # the pool lives as long as the graph
    for n in (0, 1, 5, 30):
        limit.fill_(n)
        loop()                                   # the plain form, host reads
        want = (int(it), acc.clone())
        graph_cond_kernel.reset_sets(dev)
        g.replay()
        assert int(it) == want[0] == min(n, 9)
        assert torch.equal(acc, want[1])
        assert graph_cond_kernel.sets(dev) == want[0] + 1
        assert graph_cond_kernel.slots(dev) == {"entry": 1, "ecc": 0, "pcg": want[0],
                                                "seed": 0, "fold": 0}


def test_if_node_taken_and_not_equal_the_host_branch(dev):
    from vistaf_torch.kernels import graph_cond_kernel
    from vistaf_torch.utils.cuda_graph import device_if
    pred = torch.zeros((), dtype=torch.bool, device=dev)
    out = torch.zeros(4, device=dev)

    def branch():
        out.fill_(1.0)
        device_if(pred, lambda t: t.mul_(3.0).add_(torch.ones(4, device=dev)), out,
                  site="fold")
    g, pool = _captured(dev, branch)
    for taken in (False, True):
        pred.fill_(taken)
        branch()
        want = out.clone()
        graph_cond_kernel.reset_sets(dev)
        g.replay()
        assert torch.equal(out, want) and float(want[0]) == (4.0 if taken else 1.0)
        assert graph_cond_kernel.sets(dev) == 1
        assert graph_cond_kernel.slots(dev) == {"entry": 0, "ecc": 0, "pcg": 0, "seed": 0,
                                                "fold": 1}


def test_parity_graph_replay_equals_eager_on_card(dev):
    """The 640x480 parity forward (the gather ECC and the plain PCG as WHILE
    nodes) replayed against the same forward op by op: every output bit for
    bit, the same ECC iterations."""
    from vistaf_torch.ftp.pipeline import FTPPipeline
    from vistaf_torch.utils.synthetic import scaled_ftp_config, synthetic_pair
    p2h = {"type": "hinge_saturating", "params": {"a": 2.08, "b": 4.2, "c": 0.0}}
    cfg = scaled_ftp_config(480, 640)
    pipe = FTPPipeline(cfg, p2h, device=dev)
    assert pipe.graph_route()
    pairs = [[torch.as_tensor(f, device=dev) for f in synthetic_pair(480, 640, cfg, seed=s)]
             for s in range(3)]
    pipe.forward(*pairs[0])                       # eager, then the capture
    for r, d in pairs[1:]:
        got = pipe.forward(r, d)
        want = pipe.forward_eager(r, d)
        for k in want:
            a, b = got[k], want[k]
            if a.is_floating_point():
                assert torch.equal(torch.isnan(a), torch.isnan(b)), k
                a, b = torch.nan_to_num(a), torch.nan_to_num(b)
            assert torch.equal(a, b), k


@pytest.mark.parametrize("kind", ["degree1", "deploy_form"])
def test_k8_matches_plain_on_card(dev, kind):
    """K8 against its plain version on the same card, with
    ``test_pallas_temp.py``'s tolerance (expf/logf/powf round differently
    from PyTorch's kernels, which can flip an 8-bit LAB step)."""
    from vistaf_torch.utils.synthetic import (synthetic_deploy_temp_weights,
                                              synthetic_temp_weights)
    color, wide = (synthetic_temp_weights() if kind == "degree1"
                   else synthetic_deploy_temp_weights(seed=5))
    rng = np.random.default_rng(8)
    h, w = 200, 333
    bgr = torch.as_tensor(np.round(rng.random((h, w, 3)) * 255).astype(np.float32),
                          device=dev)
    roi = torch.as_tensor(rng.random((h, w)) > 0.2, device=dev)
    cpre = roi & torch.as_tensor(rng.random((h, w)) > 0.5, device=dev)
    kernels.reset_launches()
    got = k8.fused_temperature_maps(bgr, roi, cpre, 10.0, color, wide)
    assert kernels.LAUNCHES["fused_temperature"] == 1
    want = k8.fused_temperature_maps_plain(bgr, roi, cpre, 10.0, color, wide)
    for a, b in zip(got[:2], want[:2]):
        a, b = a.cpu().numpy(), b.cpu().numpy()
        both = np.isfinite(a) & np.isfinite(b)
        assert (np.isfinite(a) != np.isfinite(b)).mean() < 2e-3
        d = np.abs(a[both] - b[both])
        assert (d > 1e-2).mean() < 2e-3 and np.percentile(d, 99.5) < 0.5
    assert (got[2] != want[2]).float().mean() < 2e-3


# (crop shape, calibrator order) of K8: the native-4K compute crop, a pixel
# count that is not a multiple of 4 (the scalar tail), and a calibrator
# whose kept x0 are out of order (the backward scan)
K8_CASES = {
    "crop_1608x1664": ((1608, 1664), "sorted"),
    "ragged_201x333": ((201, 333), "sorted"),
    "unsorted_calibrator": ((201, 333), "unsorted"),
}


@pytest.mark.parametrize("case", sorted(K8_CASES))
def test_k8_shapes_match_plain_on_card(dev, case):
    import dataclasses
    from vistaf_torch.kernels.temp_kernel import segments_sorted
    from vistaf_torch.utils.synthetic import synthetic_deploy_temp_weights
    (h, w), order = K8_CASES[case]
    color, wide = synthetic_deploy_temp_weights(seed=5)
    if order == "unsorted":
        half = color.iso_x.size // 2
        color = dataclasses.replace(
            color, iso_x=np.concatenate([color.iso_x[half:], color.iso_x[:half]]),
            iso_y=np.concatenate([color.iso_y[half:], color.iso_y[:half]]))
    assert segments_sorted(color.tables.iso_seg) == (order == "sorted")
    rng = np.random.default_rng(9)
    bgr = torch.as_tensor(np.round(rng.random((h, w, 3)) * 255).astype(np.float32),
                          device=dev)
    roi = torch.as_tensor(rng.random((h, w)) > 0.2, device=dev)
    cpre = roi & torch.as_tensor(rng.random((h, w)) > 0.5, device=dev)
    kernels.reset_launches()
    got = k8.fused_temperature_maps(bgr, roi, cpre, 10.0, color, wide)
    assert kernels.LAUNCHES["fused_temperature"] == 1
    want = k8.fused_temperature_maps_plain(bgr, roi, cpre, 10.0, color, wide)
    for a, b in zip(got[:2], want[:2]):
        a, b = a.cpu().numpy(), b.cpu().numpy()
        both = np.isfinite(a) & np.isfinite(b)
        assert (np.isfinite(a) != np.isfinite(b)).mean() < 2e-3
        d = np.abs(a[both] - b[both])
        assert (d > 1e-2).mean() < 2e-3 and np.percentile(d, 99.5) < 0.5
    assert (got[2] != want[2]).float().mean() < 2e-3


def test_temperature_on_card_launches_k1_k3_k8(dev):
    from vistaf_torch.temperature.inference import TemperaturePipeline
    from vistaf_torch.utils.synthetic import (scaled_temp_config, synthetic_deploy_temp_weights,
                                              synthetic_tlc_frame)
    cfg = scaled_temp_config(540, 960).deploy()
    color, wide = synthetic_deploy_temp_weights()
    frame = synthetic_tlc_frame(540, 960, cfg)
    kernels.reset_launches()
    gpu = TemperaturePipeline(cfg, color, wide, device=dev)(frame)
    for name in ("masked_quantiles", "inpaint_diffusion", "fused_temperature"):
        assert kernels.LAUNCHES[name] > 0, kernels.LAUNCHES
    cpu = TemperaturePipeline(cfg, color, wide, device="cpu")(frame)
    np.testing.assert_array_equal(gpu["seg_peak_xy"], cpu["seg_peak_xy"])
    assert abs(float(gpu["t_mean"]) - float(cpu["t_mean"])) <= 0.1
