"""The seven Hopper kernels against their plain PyTorch versions on the card,
and the 640x480 slice on the card against the port's CPU run.  Marked ``cuda``:
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
from vistaf_torch.kernels import ecc_kernel as k4
from vistaf_torch.kernels import ecc_loop_kernel as k5
from vistaf_torch.kernels import inpaint_kernel as k3
from vistaf_torch.kernels import polyfit_kernel as k7
from vistaf_torch.kernels import quantile_kernel as k1
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


def test_k5_matches_plain_on_card(dev):
    from vistaf_torch.ops.consts import DeviceConsts
    from vistaf_torch.ops.filters import gaussian_blur
    from vistaf_torch.ops.registration import ecc_prepare
    from vistaf_torch.ops.warp import warp_affine_inverse_shear
    rng = np.random.default_rng(2)
    base = gaussian_blur(torch.as_tensor(rng.random((236, 236)).astype(np.float32),
                                         device=dev), 3.0, DeviceConsts(dev))
    th, tx, ty = 0.002, -0.7, 0.5
    M = torch.tensor([[np.cos(th), -np.sin(th), tx], [np.sin(th), np.cos(th), ty]],
                     dtype=torch.float32, device=dev)
    moved = warp_affine_inverse_shear(base, M, K=4)
    S, T = ecc_prepare(base, moved, torch.as_tensor(_disk(236, 236, 117), device=dev))
    sm = torch.zeros_like(T)
    sm[::2, ::2] = 1.0
    for image_sign, fails in ((1.0, False), (-1.0, True)):
        S_in = S.clone()
        S_in[:3] *= image_sign       # a contrast-inverted image: StsNoConv
        pa, ra, _, fa = k5.ecc_loop_euclidean(S_in, T, sm, 4, 300, 1e-7, 25)
        pb, rb, _, fb = k5.ecc_loop_euclidean_plain(S_in, T, sm, 4, 300, 1e-7, 25)
        assert bool(fa) == bool(fb) == fails
        if not fails:
            assert abs(float(ra) - float(rb)) < 1e-4
        assert float((pa[0] - pb[0]).abs()) < 5e-5
        assert float((pa[1:] - pb[1:]).abs().max()) < 5e-3


@pytest.mark.parametrize("order", [1, 2])
def test_k7_matches_plain_on_card(dev, order):
    rng = np.random.default_rng(3)
    yy, xx = np.mgrid[0:236, 0:236].astype(np.float32) / 236.0
    z = (0.5 * xx - 0.3 * yy + 0.4 * xx * xx + 0.01 * rng.standard_normal((236, 236))
         ).astype(np.float32)
    z[rng.random((236, 236)) < 0.05] += 3.0
    zt = torch.as_tensor(z, device=dev)
    m = torch.as_tensor(_disk(236, 236, 110), device=dev)
    got = k7.robust_polyfit2d_coef(zt, m, order, 4, 4.685, 2)
    want = k7.robust_polyfit2d_coef_plain(zt, m, order, 4, 4.685, 2)
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


def test_k2_bit_equal_on_card(dev):
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 300, 310)).astype(np.float32)
    x[:, rng.random((300, 310)) > 0.97] += 8.0
    x[:, 5:9, 5:9] = np.nan
    xt = torch.as_tensor(x, device=dev)
    m = torch.as_tensor(_disk(300, 310, 140), device=dev)
    for a, b in zip(k1.masked_median_mad(xt, m), k1.masked_median_mad_plain(xt, m)):
        assert a.shape == (2,) and torch.equal(a, b)


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


def test_k6_matches_plain_on_card(dev):
    rng = np.random.default_rng(6)
    yy, xx = np.mgrid[0:236, 0:236].astype(np.float32)
    field = 0.09 * xx + 0.05 * yy + 4.0 * np.sin(xx / 30.0) * np.cos(yy / 25.0)
    wrapped = torch.as_tensor(np.angle(np.exp(1j * field)).astype(np.float32), device=dev)
    mask = torch.as_tensor(_disk(236, 236, 112) & (rng.random((236, 236)) > 0.01), device=dev)
    from vistaf_torch.ops.consts import DeviceConsts
    consts = DeviceConsts(dev)
    got = k6.unwrap_wls(wrapped, mask, consts, 16, 1e-8)
    want = k6.unwrap_wls_plain(wrapped, mask, consts, 16, 1e-8)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    same_k = (got[mask] - want[mask]).abs() < 1e-3
    assert float(same_k.float().mean()) >= 0.999


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
                 "unwrap_wls", "robust_polyfit2d"):
        assert kernels.LAUNCHES[name] > 0, kernels.LAUNCHES
    cpu = ForcePipeline(cfg, ForceConfig(), p2h, fm, device="cpu")(ref, de)
    assert abs(gpu["force_N"] - cpu["force_N"]) <= 0.01 * cpu["force_N"]
