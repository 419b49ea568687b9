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


@pytest.mark.parametrize("name", ["FTPConfig", "ForceConfig"])
def test_dataclass_fields_match(name):
    jf = {f.name: f.default for f in dataclasses.fields(getattr(jcfg, name))}
    tf = {f.name: f.default for f in dataclasses.fields(getattr(tcfg, name))}
    assert jf == tf


def test_deploy_and_slice_presets_match():
    assert dataclasses.asdict(tcfg.FTPConfig().deploy()) == \
        dataclasses.asdict(jcfg.FTPConfig().deploy())
    want = jsyn.scaled_ftp_config(480, 640).deploy()
    assert dataclasses.asdict(tcfg.slice_ftp_config(480, 640)) == dataclasses.asdict(want)


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
    cfg = tcfg.slice_ftp_config(480, 640)
    with pytest.raises(TypeError):
        FTPPipeline(cfg, P2H)
    with pytest.raises(NotImplementedError, match="unwrap_method"):
        FTPPipeline(cfg.replace(unwrap_method="flood_fill"), P2H, device="cpu")
    with pytest.raises(NotImplementedError, match="ecc_sampler"):
        FTPPipeline(cfg.replace(ecc_sampler="gather"), P2H, device="cpu")
    with pytest.raises(NotImplementedError, match="_DCT_FFT_MIN_PX"):
        FTPPipeline(tcfg.FTPConfig().deploy().replace(unwrap_downsample=1), P2H,
                    device="cpu")
    for ported in (cfg.replace(unwrap_method="wls"), tcfg.FTPConfig().deploy(),
                   cfg.replace(ecc_downsample_min_px=0, unwrap_downsample_min_px=0,
                               polyfit_kernel=False, ecc_loop_kernel=False)):
        FTPPipeline.check_config(ported)
    with pytest.raises(ValueError, match="percentile method"):
        from vistaf_torch.ops.percentile import get_percentile_fn
        get_percentile_fn("sort")
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
    full-resolution solve needs the unported FFT DCT."""
    from vistaf_torch.ftp.pipeline import unwrap_route
    from vistaf_torch.ops.unwrap import dense_dct_solve
    cfg = {"640": tcfg.slice_ftp_config(480, 640),
           "640_wls": tcfg.slice_ftp_config(480, 640).replace(unwrap_method="wls"),
           "4k": tcfg.FTPConfig().deploy(),
           "4k_full_res": tcfg.FTPConfig().deploy().replace(unwrap_downsample=1)}[preset]
    g = FTPGeometry.from_config(cfg)
    assert unwrap_route(cfg, (g.crop_h, g.crop_w)) == route
    assert dense_dct_solve(route[1]) == (preset != "4k_full_res")
