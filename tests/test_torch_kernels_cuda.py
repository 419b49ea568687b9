"""The four Hopper kernels against their plain PyTorch versions on the card,
and the slice on the card against the port's CPU run.  Marked ``cuda``:
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
from vistaf_torch.kernels import ecc_loop_kernel as k5
from vistaf_torch.kernels import inpaint_kernel as k3
from vistaf_torch.kernels import polyfit_kernel as k7
from vistaf_torch.kernels import quantile_kernel as k1

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


def test_k1_bit_equal_on_card(dev):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 236, 236)).astype(np.float32)
    x[:, 5:9, 5:9] = np.nan
    m = torch.as_tensor(_disk(236, 236, 117), device=dev)
    xt = torch.as_tensor(x, device=dev)
    for qs in ((99.9,), (92.0, 95.0, 98.0), (0.0, 50.0, 100.0)):
        assert torch.equal(k1.masked_quantiles(xt, m, qs),
                           k1.masked_quantiles_plain(xt, m, qs))
    empty = torch.zeros_like(m)
    assert torch.equal(k1.masked_quantiles(xt, empty, (50.0,)),
                       torch.zeros((2, 1), device=dev))


def test_k3_matches_plain_on_card(dev):
    rng = np.random.default_rng(1)
    img = torch.as_tensor(np.round(rng.random((2, 236, 236)) * 255).astype(np.float32),
                          device=dev)
    fill = torch.as_tensor(rng.random((2, 236, 236)) < 0.05, device=dev)
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
    assert all(n > 0 for n in kernels.LAUNCHES.values()), kernels.LAUNCHES
    cpu = ForcePipeline(cfg, ForceConfig(), p2h, fm, device="cpu")(ref, de)
    assert abs(gpu["force_N"] - cpu["force_N"]) <= 0.01 * cpu["force_N"]
