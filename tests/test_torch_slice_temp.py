"""The port's TemperaturePipeline against the JAX TemperaturePipeline on the
CPU, on ``synthetic_tlc_frame`` at a small deploy configuration with a real
compute crop: ``scaled_temp_config(320, 640).deploy()`` with the compact
circle of ``test_temp_crop_compute.py``, the deploy weights' form (degree-3
WIDE, degree-2 COLOR with 64 isotonic knots).

The JAX side runs the TPU route with its fused Pallas kernel in interpret
mode (set as ``_fused_fn``, as ``test_pallas_temp.py`` does); the port's CPU
run walks the same route with its kernels' plain versions.  Its XLA
fallbacks differ in one place, the segmentation median (the histogram
ladder instead of K1's bisection), which only fills pixels outside the ROI.
Gates: equal carrier bin, stripe angle and period; masks agree on >= 99.5%
of pixels; final-map finiteness agrees on >= 99.5%; t_mean within 0.1 degC
(the deploy contract); ``stats()`` equals ``__call__``'s scalars; no kernel
launched on the CPU.
"""
import dataclasses

import numpy as np
import pytest

from vistaf_tpu.calib.temp_weights import TempModelWeights as JaxWeights
from vistaf_tpu.pallas.temp_kernel import make_fused_temperature_fn
from vistaf_tpu.temperature.inference import TemperaturePipeline as JaxTemperaturePipeline
from vistaf_tpu.utils.synthetic import scaled_temp_config

from vistaf_torch import kernels
from vistaf_torch.config import temp_config_from_dict
from vistaf_torch.temperature.inference import STATS, TemperaturePipeline
from vistaf_torch.utils.synthetic import synthetic_deploy_temp_weights, synthetic_tlc_frame
from torch_threads import single_torch_thread  # noqa: F401  (autouse)

H, W = 320, 640
MASKS = ("mask_dark", "mask_light", "mask_sat", "mask_roi_eff", "mask_color_support")


def _jax_cfg():
    return scaled_temp_config(H, W).deploy().replace(
        outer_circle_p1=(400, 160), outer_circle_p2=(240, 160), outer_circle_p3=(320, 240))


@pytest.fixture(scope="module")
def both():
    jcfg = _jax_cfg()
    cfg = temp_config_from_dict(dataclasses.asdict(jcfg))
    color, wide = synthetic_deploy_temp_weights(seed=0)
    jc, jw = (JaxWeights(**dataclasses.asdict(m)) for m in (color, wide))
    frame = synthetic_tlc_frame(H, W, cfg, seed=0)
    jpipe = JaxTemperaturePipeline(jcfg, jc, jw)
    jpipe._fused_fn = make_fused_temperature_fn(jcfg, jc, jw, interpret=True)
    jres = jpipe(frame)
    kernels.reset_launches()
    pipe = TemperaturePipeline(cfg, color, wide, device="cpu")
    tres = pipe(frame)
    tstats = pipe.stats(frame)
    return jres, tres, tstats, dict(kernels.LAUNCHES), pipe, jpipe


def test_segmentation_matches(both):
    jres, tres, *_ = both
    np.testing.assert_array_equal(tres["seg_peak_xy"], jres["seg_peak_xy"])
    np.testing.assert_allclose(tres["stripe_angle_rad"], jres["stripe_angle_rad"],
                               rtol=1e-6)
    np.testing.assert_allclose(tres["stripe_period_px"], jres["stripe_period_px"],
                               rtol=1e-6)


@pytest.mark.parametrize("key", MASKS)
def test_masks_agree(both, key):
    jres, tres, *_ = both
    assert tres[key].shape == jres[key].shape == (H, W)
    assert np.mean(tres[key] == jres[key]) >= 0.995, key


def test_maps_and_stats_within_the_deploy_contract(both):
    jres, tres, *_ = both
    a, b = tres["temperature_map_final"], jres["temperature_map_final"]
    assert a.shape == b.shape == (H, W)
    assert np.mean(np.isfinite(a) == np.isfinite(b)) >= 0.995
    assert abs(float(tres["t_mean"]) - float(jres["t_mean"])) <= 0.1
    assert abs(int(tres["valid_pixels"]) - int(jres["valid_pixels"])) \
        <= 0.005 * int(jres["valid_pixels"])
    assert "chroma" not in tres and "chroma" not in jres
    assert set(tres) == set(jres)
    # the scene drives both models: COLOR wins on a real share of the ROI
    roi = tres["roi_outer"]
    assert np.mean(tres["source_map"][roi] == 255) >= 0.01


def test_stats_equal_call_and_no_launch_on_cpu(both):
    _, tres, tstats, launches, *_ = both
    for k in STATS:
        assert np.asarray(tstats[k]) == np.asarray(tres[k]), k
    assert all(v == 0 for v in launches.values()), launches


def test_geometry_matches(both):
    *_, pipe, jpipe = both
    assert pipe._compute_bbox == jpipe._compute_bbox
    y0, y1, x0, x1 = pipe._compute_bbox
    assert (y1 - y0) < H or (x1 - x0) < W
    assert pipe._crop_bbox == jpipe._crop_bbox
    assert np.array_equal(pipe._roi_full, np.asarray(jpipe._roi_full))
    # the annulus ROI, construction only
    jcfg = _jax_cfg().replace(use_inner_circle=True)
    color, wide = synthetic_deploy_temp_weights(seed=0)
    jc, jw = (JaxWeights(**dataclasses.asdict(m)) for m in (color, wide))
    jp = JaxTemperaturePipeline(jcfg, jc, jw)
    tp = TemperaturePipeline(temp_config_from_dict(dataclasses.asdict(jcfg)), color, wide,
                             device="cpu")
    assert np.array_equal(tp._roi_full, np.asarray(jp._roi_full))


def test_check_config_accepts_deploy_and_rejects_the_unported_knobs():
    """Every knob value of the JAX package is ported now: each one the list
    names, alone on the deploy preset, is accepted and builds a pipeline,
    and so do odd frame sides; only a value the JAX package does not know
    raises."""
    from vistaf_torch.config import TempConfig
    import inspect
    TemperaturePipeline.check_config(TempConfig().deploy())
    TemperaturePipeline.check_config(TempConfig())
    assert inspect.signature(TemperaturePipeline).parameters["device"].default == "cuda"
    dep = TempConfig().deploy()
    color, wide = synthetic_deploy_temp_weights(seed=0)
    for knob, value in (("rotate_method", "gather"), ("seg_peak_method", "topk"),
                        ("seg_bandpass", "fft"), ("seg_fft", "fft2"),
                        ("percentile_method", "sort"), ("percentile_method", "hist"),
                        ("use_fused_kernel", False), ("seg_force_right_half_plane", False),
                        ("image_width", 3841)):
        cfg = dep.replace(**{knob: value})
        TemperaturePipeline.check_config(cfg)
        assert TemperaturePipeline(cfg, color, wide, device="cpu").cfg == cfg
    for knob in ("rotate_method", "seg_peak_method", "seg_bandpass", "seg_fft",
                 "percentile_method"):
        with pytest.raises(ValueError, match=knob):
            TemperaturePipeline.check_config(dep.replace(**{knob: "bogus"}))
