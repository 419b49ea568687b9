"""The port's TemperaturePipeline under the parity preset (``TempConfig()``,
the CLI's default temperature numerics) against the JAX
TemperaturePipeline on the CPU, on ``synthetic_tlc_frame`` with the deploy
weights' form (degree-3 WIDE, degree-2 COLOR with 64 isotonic knots).

``scaled_temp_config(320, 640)`` is the JAX package's parity form at that
size: sort percentiles, the full ``fft2`` spectrum with the top-k carrier
search and the full-frame masked ``ifft2`` bandpass, the unfused LAB and
``predict``, the banded-matmul blurs, 96/48 inpaint iterations and the
gather rotation, all on the full frame.  Both sides run the same route; the
JAX side is its TPU route too, where the inpaints are the XLA diffusion that
K3 replaces.  Gates, the temperature contract: equal carrier bin, masks
agree on >= 99.5% of pixels, t_mean within 0.1 degC, t_min and t_max within
0.75 degC, valid pixels within 0.5%; ``stats()`` equals ``__call__``'s
scalars; no kernel launched on the CPU.

The knob sweep, at 160x320: each knob that ``deploy()`` sets, flipped alone
from the parity preset, the 'hist' percentiles, the left half-plane carrier
search and odd frame sides (which take the full spectrum), each against
JAX with the same gates, so that every spectrum route, bandpass, rotation,
percentile method and model path is held.  Where ``use_fused_kernel`` is
set, the JAX side runs its Pallas kernel in interpret mode (its TPU route),
the port K8's plain version.
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

MASKS = ("mask_dark", "mask_light", "mask_sat", "mask_roi_eff", "mask_color_support",
         "mask_color_ok")


def run_both(jcfg):
    """(JAX result, port result, port stats(), port launch counts)."""
    cfg = temp_config_from_dict(dataclasses.asdict(jcfg))
    color, wide = synthetic_deploy_temp_weights(seed=0)
    jc, jw = (JaxWeights(**dataclasses.asdict(m)) for m in (color, wide))
    frame = synthetic_tlc_frame(jcfg.image_height, jcfg.image_width, cfg, seed=0)
    jpipe = JaxTemperaturePipeline(jcfg, jc, jw)
    if jcfg.use_fused_kernel:
        jpipe._fused_fn = make_fused_temperature_fn(jcfg, jc, jw, interpret=True)
    jres = jpipe(frame)
    kernels.reset_launches()
    pipe = TemperaturePipeline(cfg, color, wide, device="cpu")
    tres = pipe(frame)
    tstats = pipe.stats(frame)
    return jres, tres, tstats, dict(kernels.LAUNCHES)


def assert_contract(jres, tres):
    np.testing.assert_array_equal(tres["seg_peak_xy"], jres["seg_peak_xy"])
    for key in MASKS:
        assert tres[key].shape == jres[key].shape
        assert np.mean(tres[key] == jres[key]) >= 0.995, key
    assert abs(float(tres["t_mean"]) - float(jres["t_mean"])) <= 0.1
    assert abs(float(tres["t_min"]) - float(jres["t_min"])) <= 0.75
    assert abs(float(tres["t_max"]) - float(jres["t_max"])) <= 0.75
    assert int(tres["valid_pixels"]) > 0
    assert abs(int(tres["valid_pixels"]) - int(jres["valid_pixels"])) \
        <= 0.005 * int(jres["valid_pixels"])
    assert set(tres) == set(jres)
    # the scene drives both models: COLOR wins on a real share of the ROI
    assert np.mean(tres["source_map"][tres["roi_outer"]] == 255) >= 0.01


@pytest.fixture(scope="module")
def parity():
    return run_both(scaled_temp_config(320, 640))


def test_parity_preset_within_the_contract(parity):
    jres, tres, *_ = parity
    assert_contract(jres, tres)
    a, b = tres["temperature_map_final"], jres["temperature_map_final"]
    assert a.shape == b.shape == (320, 640)
    assert np.mean(np.isfinite(a) == np.isfinite(b)) >= 0.995
    np.testing.assert_allclose(tres["stripe_angle_rad"], jres["stripe_angle_rad"], rtol=1e-6)
    np.testing.assert_allclose(tres["stripe_period_px"], jres["stripe_period_px"], rtol=1e-6)


def test_parity_returns_chroma(parity):
    """With the fused kernel off, both packages return the chroma map; the
    LAB planes it comes from differ where a value sits on a .5 boundary."""
    jres, tres, *_ = parity
    a, b = tres["chroma"], jres["chroma"]
    assert a.shape == b.shape == (320, 640) and a.dtype == np.float32
    assert np.mean(a == b) >= 0.999


def test_parity_stats_equal_call_and_no_launch_on_cpu(parity):
    _, tres, tstats, launches = parity
    for k in STATS:
        assert np.asarray(tstats[k]) == np.asarray(tres[k]), k
    assert all(v == 0 for v in launches.values()), launches


SWEEP = {
    "percentile_hist_pallas": dict(percentile_method="hist_pallas"),
    "percentile_hist": dict(percentile_method="hist"),
    "use_fused_kernel": dict(use_fused_kernel=True),
    "inpaint_iters": dict(wide_inpaint_iters=16, color_inpaint_iters=8),
    "rotate_shear": dict(rotate_method="shear"),
    "crop_compute": dict(crop_compute=True),
    "conv_vpu": dict(conv_vpu=True),
    "peak_cascade": dict(seg_peak_method="cascade"),
    "bandpass_matmul": dict(seg_bandpass="matmul"),
    "seg_rfft2_alone": dict(seg_fft="rfft2"),
    "left_half_plane": dict(seg_force_right_half_plane=False),
    "odd_width": dict(image_width=321),
    "odd_height_rfft_preconditions": dict(image_height=161, seg_fft="rfft2",
                                          seg_peak_method="cascade", seg_bandpass="matmul"),
}


@pytest.mark.parametrize("name", list(SWEEP))
def test_knob_sweep_matches_jax(name):
    jres, tres, tstats, launches = run_both(scaled_temp_config(160, 320).replace(**SWEEP[name]))
    assert_contract(jres, tres)
    for k in STATS:
        assert np.asarray(tstats[k]) == np.asarray(tres[k]), k
    assert all(v == 0 for v in launches.values()), launches
