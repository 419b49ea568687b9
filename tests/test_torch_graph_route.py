"""Which forwards replay a CUDA graph, and that the captured forward reads
nothing on the host, on the CPU.

``FTPPipeline.capturable`` is a function of the config and the frame shape:
True for the 640x480 deploy preset (BASELINE configs 1 to 3, the streams and
the limb heads run it), the name of the host-driven loop elsewhere.  The
640x480 deploy forward is then run on the CPU with every way of reading a
tensor on the host made to raise (``Tensor.__bool__``, ``item``, ``tolist``,
``cpu``, ``numpy``, ``__float__``, ``__int__``, ``__index__``, an index by
a 0-dim tensor, whose value PyTorch takes on the host, or by a boolean mask,
and ``nonzero`` and the other ops whose output size the host must read),
and with ``torch.tensor``, ``torch.as_tensor`` and ``torch.from_numpy`` of
host values raising too (a CUDA graph can capture neither a read nor a copy
from the host).  The plain versions of the kernels on its routes are exempt: K1,
K3, K4 (the prealignment's ECC), K5, K6 and K7, the labelling kernel and the
reconstruction loop that the labels replace on the card; on the card each
is one launch of a kernel that reads nothing on the host.
"""
import contextlib
import functools

import numpy as np
import pytest
import torch

from vistaf_torch.config import FTPConfig, slice_ftp_config
from vistaf_torch.ftp.pipeline import FTPPipeline
from vistaf_torch.kernels import (ccl_kernel, ecc_kernel, ecc_loop_kernel, inpaint_kernel,
                                  polyfit_kernel, quantile_kernel, unwrap_kernel)
from vistaf_torch.ops import morphology
from vistaf_torch.utils.synthetic import scaled_ftp_config, synthetic_pair
from torch_threads import single_torch_thread  # noqa: F401  (autouse)

P2H = {"type": "hinge_saturating", "params": {"a": 1.2, "b": 0.8, "c": 0.02}}


@pytest.mark.parametrize("name,cfg,shape,want", [
    ("640_deploy", slice_ftp_config(480, 640), (480, 640), True),
    ("640_deploy_prealign", slice_ftp_config(480, 640).replace(use_grating_band_prealign=True),
     (480, 640), True),
    ("640_deploy_hist_irls", slice_ftp_config(480, 640).replace(
        percentile_method="hist", polyfit_kernel=False), (480, 640), True),
    ("4k_deploy", FTPConfig().deploy(), (2160, 3840), "ecc_loop"),
    ("4k_parity", FTPConfig(), (2160, 3840), "ecc_loop"),
    ("640_parity", scaled_ftp_config(480, 640), (480, 640), "ecc_loop"),
    ("640_deploy_translation", slice_ftp_config(480, 640).replace(ecc_warp_mode="translation"),
     (480, 640), "ecc_loop"),
    ("640_deploy_prealign_affine", slice_ftp_config(480, 640).replace(
        use_grating_band_prealign=True, grating_prealign_ecc_mode="affine"), (480, 640),
     "prealign_ecc_loop"),
    ("640_deploy_plain_pcg", slice_ftp_config(480, 640).replace(unwrap_method="wls"),
     (480, 640), "pcg_loop"),
    ("640_deploy_no_ecc_pooled_pcg", slice_ftp_config(480, 640).replace(
        use_ecc_crop_alignment=False, unwrap_downsample_min_px=64), (480, 640), "pcg_loop"),
], ids=lambda v: v if isinstance(v, str) else None)
def test_capturable_names_the_host_loop(name, cfg, shape, want):
    assert FTPPipeline.capturable(cfg, shape) == want


def test_graph_route_only_on_the_card_without_debug_or_stop_after():
    cfg = slice_ftp_config(480, 640)
    shape = (480, 640)
    assert not FTPPipeline(cfg, P2H, device="cpu").graph_route(shape)
    for kw in ({"debug_outputs": True}, {"stop_after": "unwrap"}, {}):
        pipe = FTPPipeline(cfg, P2H, device="cpu", **kw)
        pipe.device = torch.device("cuda")      # the route rule alone; nothing runs
        assert pipe.graph_route(shape) == (not kw)


class HostRead(AssertionError):
    pass


@contextlib.contextmanager
def no_host_reads(monkeypatch, exempt):
    """Make reading a tensor on the host, and building one from host values,
    raise unless an ``exempt`` function is on the stack."""
    depth = [0]

    def guarded(name, real):
        @functools.wraps(real)
        def f(*a, **k):
            if depth[0] == 0:
                raise HostRead(f"{name} inside the forward")
            return real(*a, **k)
        return f

    def building(name, real):
        @functools.wraps(real)
        def f(data, *a, **k):
            if depth[0] == 0 and not isinstance(data, torch.Tensor):
                raise HostRead(f"torch.{name} of host values inside the forward")
            return real(data, *a, **k)
        return f

    def indexing(name, real):
        """An index that reads the device: a 0-dim tensor (PyTorch takes its
        value on the host) or a boolean mask (its nonzero count)."""
        @functools.wraps(real)
        def f(self, index, *a):
            parts = index if isinstance(index, tuple) else (index,)
            if depth[0] == 0 and any(isinstance(p, torch.Tensor) and (
                    p.dim() == 0 or p.dtype == torch.bool) for p in parts):
                raise HostRead(f"Tensor.{name} with a 0-dim or boolean tensor index "
                               "inside the forward")
            return real(self, index, *a)
        return f

    def exempted(real):
        @functools.wraps(real)
        def f(*a, **k):
            depth[0] += 1
            try:
                return real(*a, **k)
            finally:
                depth[0] -= 1
        return f

    for module, name in exempt:
        monkeypatch.setattr(module, name, exempted(getattr(module, name)))
    for name in ("__bool__", "item", "tolist", "cpu", "numpy", "__float__", "__int__",
                 "__index__"):
        monkeypatch.setattr(torch.Tensor, name, guarded(name, getattr(torch.Tensor, name)))
    for name in ("tensor", "as_tensor", "from_numpy"):
        monkeypatch.setattr(torch, name, building(name, getattr(torch, name)))
    for name in ("nonzero", "argwhere", "masked_select", "unique", "repeat_interleave"):
        monkeypatch.setattr(torch, name, guarded(f"torch.{name}", getattr(torch, name)))
    for name in ("nonzero", "masked_select", "unique", "repeat_interleave"):
        monkeypatch.setattr(torch.Tensor, name, guarded(name, getattr(torch.Tensor, name)))
    for name in ("__getitem__", "__setitem__"):
        monkeypatch.setattr(torch.Tensor, name, indexing(name, getattr(torch.Tensor, name)))
    try:
        yield
    finally:
        monkeypatch.undo()


PLAIN_VERSIONS = (
    (quantile_kernel, "masked_quantiles_plain"),           # K1
    (inpaint_kernel, "inpaint_diffusion_plain"),           # K3
    (ecc_kernel, "gn_loop_euclidean_plain"),               # K4 (the prealignment's ECC)
    (ecc_loop_kernel, "ecc_loop_euclidean_plain"),         # K5
    (unwrap_kernel, "unwrap_wls_plain"),                   # K6
    (polyfit_kernel, "robust_polyfit2d_coef_plain"),       # K7
    (ccl_kernel, "label_components_plain"),                # the labels
    (morphology, "reconstruct_plain"),                     # the labels' reconstruction
)


def test_the_guard_catches_host_reads(monkeypatch):
    t = torch.ones(3)
    with no_host_reads(monkeypatch, ()):
        for read in (lambda: bool(t[0]), lambda: t.sum().item(), lambda: float(t[0]),
                     lambda: t.tolist(), lambda: t.numpy(), lambda: torch.tensor([1.0]),
                     lambda: t[torch.argmax(t)], lambda: t[t > 0], lambda: t.nonzero()):
            with pytest.raises(HostRead):
                read()


@pytest.mark.parametrize("change", [
    {}, {"use_grating_band_prealign": True},
    {"percentile_method": "hist", "polyfit_kernel": False},
    {"percentile_method": "sort", "peak_method": "topk", "lock_carrier_to_reference": False,
     "use_hann_window": True, "sideband_method": "gauss", "use_two_pass_detrend": False,
     "fill_internal_holes_in_reliable": True, "largest_cc_method": "label"},
], ids=["deploy", "prealign", "hist_irls", "knobs"])
def test_capturable_forward_reads_nothing_on_the_host(monkeypatch, change):
    """The 640x480 deploy forward (and capturable variants: the
    prealignment, the histogram percentiles with the non-fused IRLS, the
    other knobs that keep the route on the device) after one warm-up call,
    as the card's capture follows one: every output as the unguarded call
    gives it."""
    cfg = slice_ftp_config(480, 640).replace(**change)
    assert FTPPipeline.capturable(cfg, (480, 640)) is True
    ref, de = synthetic_pair(480, 640, cfg, seed=3)
    pipe = FTPPipeline(cfg, P2H, device="cpu")
    r, d = pipe.upload(ref), pipe.upload(de)
    want = pipe.forward(r, d)
    with no_host_reads(monkeypatch, PLAIN_VERSIONS):
        got = pipe.forward(r, d)
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]) or (
            got[k].is_floating_point() and torch.equal(torch.isnan(got[k]),
                                                       torch.isnan(want[k]))
            and torch.equal(torch.nan_to_num(got[k]), torch.nan_to_num(want[k]))), k
