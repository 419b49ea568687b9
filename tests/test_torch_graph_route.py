"""Which forwards replay a CUDA graph, and that the captured forward reads
nothing on the host, on the CPU.

Every ``FTPPipeline`` replays a CUDA graph on the card unless it has debug
outputs or a ``stop_after`` (``FTPPipeline.graph_route``): its ECC and PCG
loops and its seed pick are ``device_while`` and ``device_if``, conditional
nodes of the graph.  The forwards are run on the CPU with every way of
reading a tensor on the host made to raise (``Tensor.__bool__``, ``item``,
``tolist``, ``cpu``, ``numpy``, ``__float__``, ``__int__``, ``__index__``,
an index by a 0-dim tensor, whose value PyTorch takes on the host, or by a
boolean mask, and ``nonzero`` and the other ops whose output size the host
must read), and with ``torch.tensor``, ``torch.as_tensor`` and
``torch.from_numpy`` of host values raising too, and a Python number
written to one element, which PyTorch copies from a host tensor (a CUDA
graph can capture neither a read nor a copy from the host).  Exempt: the one host read of
``device_while``'s and ``device_if``'s plain forms (the condition setter's
plain version, ``set_conditional_plain``; under a capture a conditional
node reads its condition on the card), and the plain
versions of the kernels on the routes: K1, K3, K4, K5, K6 and K7, the
labelling kernel and the reconstruction loop that the labels replace on
the card; on the card each is one launch of a kernel that reads nothing on
the host.
"""
import pytest
import torch

from vistaf_torch.config import FTPConfig, slice_ftp_config
from vistaf_torch.ftp.pipeline import FTPPipeline
from vistaf_torch.utils.synthetic import scaled_ftp_config, synthetic_pair
from torch_host_guard import PLAIN_VERSIONS, HostRead, no_host_reads, same_tensors
from torch_threads import single_torch_thread  # noqa: F401  (autouse)

P2H = {"type": "hinge_saturating", "params": {"a": 1.2, "b": 0.8, "c": 0.02}}


DEPLOY_640 = slice_ftp_config(480, 640)
# the 640 deploy preset on the native-4K deploy route: the pooled ECC seeded
# by its coarse solve (ecc_downsample_min_px), the pooled PCG
# (unwrap_downsample_min_px) and the pooled seed's device_if
DEPLOY_4K_ROUTE_640 = DEPLOY_640.replace(ecc_downsample_min_px=200,
                                         unwrap_downsample_min_px=200)


@pytest.mark.parametrize("name,cfg,shape,want", [
    ("640_deploy", DEPLOY_640, (480, 640), True),
    ("640_deploy_prealign", DEPLOY_640.replace(use_grating_band_prealign=True),
     (480, 640), True),
    ("640_deploy_hist_irls", DEPLOY_640.replace(
        percentile_method="hist", polyfit_kernel=False), (480, 640), True),
    ("4k_deploy", FTPConfig().deploy(), (2160, 3840), True),
    ("4k_parity", FTPConfig(), (2160, 3840), True),
    ("640_parity", scaled_ftp_config(480, 640), (480, 640), True),
    ("640_deploy_translation", DEPLOY_640.replace(ecc_warp_mode="translation"),
     (480, 640), True),
    ("640_deploy_prealign_affine", DEPLOY_640.replace(
        use_grating_band_prealign=True, grating_prealign_ecc_mode="affine"), (480, 640),
     True),
    ("640_deploy_plain_pcg", DEPLOY_640.replace(unwrap_method="wls"), (480, 640), True),
    ("640_deploy_no_ecc_pooled_pcg", DEPLOY_640.replace(
        use_ecc_crop_alignment=False, unwrap_downsample_min_px=64), (480, 640), True),
], ids=lambda v: v if isinstance(v, str) else None)
def test_capturable_names_the_host_loop(name, cfg, shape, want):
    """No route keeps a loop on the host any more: each of these forwards,
    which until the loops became conditional nodes ran op by op on the card
    (the host-driven ECC, prealignment ECC or PCG loop named), replays a
    graph there."""
    assert (cfg.image_height, cfg.image_width) == shape
    pipe = FTPPipeline(cfg, P2H, device="cpu")
    assert not pipe.graph_route()
    pipe.device = torch.device("cuda")      # the route rule alone; nothing runs
    assert pipe.graph_route() is want


def test_graph_route_only_on_the_card_without_debug_or_stop_after():
    cfg = DEPLOY_640
    assert not FTPPipeline(cfg, P2H, device="cpu").graph_route()
    for kw in ({"debug_outputs": True}, {"stop_after": "unwrap"}, {}):
        pipe = FTPPipeline(cfg, P2H, device="cpu", **kw)
        pipe.device = torch.device("cuda")      # the route rule alone; nothing runs
        assert pipe.graph_route() == (not kw)


def test_the_guard_catches_host_reads(monkeypatch):
    t = torch.ones(3)
    with no_host_reads(monkeypatch, ()):
        def set_one():
            t[0] = 0.0
        for read in (lambda: bool(t[0]), lambda: t.sum().item(), lambda: float(t[0]),
                     lambda: t.tolist(), lambda: t.numpy(), lambda: torch.tensor([1.0]),
                     lambda: t[torch.argmax(t)], lambda: t[t > 0], lambda: t.nonzero(),
                     set_one):
            with pytest.raises(HostRead):
                read()


@pytest.mark.parametrize("base,change", [
    (DEPLOY_640, {}), (DEPLOY_640, {"use_grating_band_prealign": True}),
    (DEPLOY_640, {"percentile_method": "hist", "polyfit_kernel": False}),
    (DEPLOY_640, {"percentile_method": "sort", "peak_method": "topk",
                  "lock_carrier_to_reference": False, "use_hann_window": True,
                  "sideband_method": "gauss", "use_two_pass_detrend": False,
                  "fill_internal_holes_in_reliable": True, "largest_cc_method": "label"}),
    (scaled_ftp_config(480, 640), {}),
    (DEPLOY_640, {"ecc_warp_mode": "translation"}),
    (DEPLOY_640, {"use_grating_band_prealign": True, "grating_prealign_ecc_mode": "affine"}),
    (DEPLOY_640, {"unwrap_method": "wls"}),
    (DEPLOY_640, {"use_ecc_crop_alignment": False, "unwrap_downsample_min_px": 64}),
    (DEPLOY_4K_ROUTE_640, {}),
], ids=["deploy", "prealign", "hist_irls", "knobs", "parity", "translation",
        "prealign_affine", "plain_pcg", "pooled_pcg", "deploy_4k_route"])
def test_capturable_forward_reads_nothing_on_the_host(monkeypatch, base, change):
    """The 640x480 forwards of every route (the deploy preset, with the
    prealignment, the histogram percentiles with the non-fused IRLS and the
    other knobs on the device kernels; the parity preset's gather ECC and
    plain PCG; the translation ECC and the affine prealignment on the plain
    shear moments; the plain and the pooled PCG; the native-4K deploy route
    forced at this size) after one warm-up call, as the card's capture
    follows one: every output as the unguarded call gives it."""
    cfg = base.replace(**change)
    ref, de = synthetic_pair(480, 640, cfg, seed=3)
    pipe = FTPPipeline(cfg, P2H, device="cpu")
    r, d = pipe.upload(ref), pipe.upload(de)
    want = pipe.forward(r, d)
    with no_host_reads(monkeypatch, PLAIN_VERSIONS):
        got = pipe.forward(r, d)
    same_tensors(got, want)
