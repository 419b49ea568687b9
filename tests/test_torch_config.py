"""The port's config copies, synthetic frames and static geometry against
the JAX package's: field by field, byte for byte, bit for bit."""
import dataclasses

import numpy as np
import pytest

import vistaf_tpu.config as jcfg
from vistaf_tpu.ftp.pipeline import FTPPipeline as JaxFTPPipeline
from vistaf_tpu.utils import synthetic as jsyn

import vistaf_torch.config as tcfg
from vistaf_torch.ftp.pipeline import FTPGeometry, FTPPipeline
from vistaf_torch.utils import synthetic as tsyn

P2H = {"type": "hinge_saturating", "params": {"a": 2.08, "b": 4.2, "c": 0.0}}


@pytest.mark.parametrize("name", ["FTPConfig", "ForceConfig", "TempConfig", "SessionConfig"])
def test_dataclass_fields_match(name):
    jf = {f.name: f.default for f in dataclasses.fields(getattr(jcfg, name))}
    tf = {f.name: f.default for f in dataclasses.fields(getattr(tcfg, name))}
    assert jf == tf


def test_deploy_and_slice_presets_match():
    assert dataclasses.asdict(tcfg.FTPConfig().deploy()) == \
        dataclasses.asdict(jcfg.FTPConfig().deploy())
    want = jsyn.scaled_ftp_config(480, 640).deploy()
    assert dataclasses.asdict(tcfg.slice_ftp_config(480, 640)) == dataclasses.asdict(want)


def test_temp_presets_match():
    assert dataclasses.asdict(tcfg.TempConfig().deploy()) == \
        dataclasses.asdict(jcfg.TempConfig().deploy())
    for h, w in ((320, 640), (480, 640), (2160, 3840)):
        assert dataclasses.asdict(tsyn.scaled_temp_config(h, w).deploy()) == \
            dataclasses.asdict(jsyn.scaled_temp_config(h, w).deploy())
    cfg = jsyn.scaled_temp_config(320, 640).deploy()
    assert dataclasses.asdict(tcfg.temp_config_from_dict(dataclasses.asdict(cfg))) == \
        dataclasses.asdict(cfg)
    with pytest.raises(ValueError):
        tcfg.temp_config_from_dict({"no_such_field": 1})


def test_synthetic_temp_weights_match():
    for a, b in zip(jsyn.synthetic_temp_weights(), tsyn.synthetic_temp_weights()):
        for f in dataclasses.fields(a):
            x, y = getattr(a, f.name), getattr(b, f.name)
            assert np.array_equal(x, y) if isinstance(x, np.ndarray) else x == y, f.name


def test_config_round_trip_from_jax_dicts():
    cfg = jsyn.scaled_ftp_config(480, 640).deploy()
    ported = tcfg.ftp_config_from_dict(dataclasses.asdict(cfg))
    assert dataclasses.asdict(ported) == dataclasses.asdict(cfg)
    fc = jcfg.ForceConfig(grating_pitch_mm=1.5, override_mm_per_px=0.2)
    assert dataclasses.asdict(tcfg.force_config_from_dict(dataclasses.asdict(fc))) == \
        dataclasses.asdict(fc)
    with pytest.raises(ValueError):
        tcfg.ftp_config_from_dict({"no_such_field": 1})


@pytest.mark.parametrize("hw,seed", [((480, 640), 0), ((120, 160), 3)])
def test_synthetic_pair_byte_identical(hw, seed):
    h, w = hw
    a = jsyn.synthetic_pair(h, w, jsyn.scaled_ftp_config(h, w), seed=seed)
    b = tsyn.synthetic_pair(h, w, tsyn.scaled_ftp_config(h, w), seed=seed)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes()


def test_geometry_arrays_bit_equal():
    jc = jsyn.scaled_ftp_config(480, 640).deploy().replace(unwrap_method="wls")
    jp = JaxFTPPipeline(jc, P2H)
    tp = FTPPipeline(tcfg.slice_ftp_config(480, 640), P2H, device="cpu")
    assert dataclasses.asdict(tp.geom) == dataclasses.asdict(jp.geom)
    assert (tp.geom.crop_h, tp.geom.crop_w) == (236, 236)
    for name in ("_circ_mask", "_roi_eroded", "_apo", "_hann_full"):
        a, b = np.asarray(getattr(jp, name)), getattr(tp, name)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), name
    # and the device copies hold the same bits
    assert np.array_equal(tp.apo.numpy(), tp._apo)
    assert np.array_equal(tp.circ.numpy(), tp._circ_mask)


def test_pipeline_requires_an_explicit_device_and_a_ported_config():
    """The force entry points default to the card, so a run without one must
    name ``device="cpu"``; configurations with unported knobs raise."""
    import inspect
    import torch
    from vistaf_torch.pipelines.force import ForcePipeline
    cfg = tcfg.slice_ftp_config(480, 640)
    # the entry points run on the card unless the caller names the CPU
    for cls in (FTPPipeline, ForcePipeline):
        assert inspect.signature(cls).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            FTPPipeline(cfg, P2H)
    with pytest.raises(NotImplementedError, match="unwrap_method"):
        FTPPipeline(cfg.replace(unwrap_method="flood_fill"), P2H, device="cpu")
    with pytest.raises(NotImplementedError, match="ecc_warp_mode"):
        FTPPipeline(cfg.replace(ecc_warp_mode="affine"), P2H, device="cpu")
    with pytest.raises(NotImplementedError, match="percentile_method"):
        FTPPipeline(tcfg.FTPConfig().deploy().replace(unwrap_downsample=1,
                                                      percentile_method="hist_rows"),
                    P2H, device="cpu")
    for ported in (cfg.replace(unwrap_method="wls"), tcfg.FTPConfig().deploy(),
                   tcfg.FTPConfig().deploy().replace(unwrap_downsample=1,
                                                     percentile_method="hist"),
                   cfg.replace(ecc_downsample_min_px=0, unwrap_downsample_min_px=0,
                               polyfit_kernel=False, ecc_loop_kernel=False),
                   cfg.replace(ecc_sampler="gather", ecc_stride=1),
                   tcfg.FTPConfig().deploy().replace(unwrap_downsample=1)):
        FTPPipeline.check_config(ported)
    with pytest.raises(ValueError, match="percentile method"):
        from vistaf_torch.ops.percentile import get_percentile_fn
        get_percentile_fn("bisect")
    assert FTPGeometry.from_config(cfg).bbox == (204, 440, 143, 379)


@pytest.mark.parametrize("preset,route", [
    ("640", ("k6", (236, 236))),
    ("640_wls", ("plain", (236, 236))),
    ("4k", ("pooled", (296, 296))),
    ("4k_full_res", ("plain", (1182, 1182))),
])
def test_unwrap_route_of_each_preset(preset, route):
    """The JAX package's unwrap dispatch: K6 for the shipped 640 preset, the
    plain PCG for ``wls``, the 4x-pooled grid at native 4K; a 1182x1182
    full-resolution solve takes the FFT-based DCT."""
    from vistaf_torch.ftp.pipeline import unwrap_route
    from vistaf_torch.ops.unwrap import dense_dct_solve
    cfg = {"640": tcfg.slice_ftp_config(480, 640),
           "640_wls": tcfg.slice_ftp_config(480, 640).replace(unwrap_method="wls"),
           "4k": tcfg.FTPConfig().deploy(),
           "4k_full_res": tcfg.FTPConfig().deploy().replace(unwrap_downsample=1)}[preset]
    g = FTPGeometry.from_config(cfg)
    assert unwrap_route(cfg, (g.crop_h, g.crop_w)) == route
    assert dense_dct_solve(route[1]) == (preset != "4k_full_res")
