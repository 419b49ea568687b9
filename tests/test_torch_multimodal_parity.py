"""The port's MultimodalPipeline under the parity presets (the CLI's default
``multimodal`` numerics) against the JAX MultimodalPipeline on the CPU:
``scaled_ftp_config(240, 320)`` and ``scaled_temp_config(240, 320)`` (no
``deploy()``), the deploy weights' form (``synthetic_deploy_temp_weights``),
on one frame pair that carries both the grating and the thermochromic
colour (``torch_slice_gates.compose_multimodal_frame``).

The gates of ``test_torch_multimodal.py``: force, volume, area and depth
within 1%, equal carrier bins, ECC warp within 0.05 px; temperature t_mean
within 0.1 degC, t_min and t_max within 0.75 degC, valid pixels within
0.5%, equal stripe carrier, COLOR on >= 1% of the ROI.  Within the port,
``step_fused`` is held to ``__call__`` with the tolerances of
``test_multimodal_fused.py`` (height map rtol 1e-5 atol 1e-6, scalars rel
1e-4, temperature map atol 1e-4, stats 1e-3 degC), its scalar fetch to its
map fetch at rel 1e-6, and the sequential path to the two pipelines run
alone, bit for bit.  The force forward runs the gather ECC, whose loop
stops on a host check; ``step_fused`` still reduces volume and force on
the device and fetches its scalars once.
"""
import dataclasses

import numpy as np
import pytest

from vistaf_tpu.calib.temp_weights import TempModelWeights as JaxWeights
from vistaf_tpu.config import ForceConfig as JaxForceConfig
from vistaf_tpu.pipelines.force import ForcePipeline as JaxForcePipeline
from vistaf_tpu.pipelines.multimodal import MultimodalPipeline as JaxMultimodalPipeline
from vistaf_tpu.temperature.inference import TemperaturePipeline as JaxTemperaturePipeline
from vistaf_tpu.utils.synthetic import scaled_ftp_config, scaled_temp_config, synthetic_pair

from vistaf_torch import kernels
from vistaf_torch.config import (force_config_from_dict, ftp_config_from_dict,
                                 temp_config_from_dict)
from vistaf_torch.pipelines.force import ForcePipeline
from vistaf_torch.pipelines.multimodal import MultimodalPipeline
from vistaf_torch.temperature.inference import TemperaturePipeline
from vistaf_torch.utils.synthetic import synthetic_deploy_temp_weights, synthetic_tlc_frame

import torch_slice_gates as gates
from torch_threads import single_torch_thread  # noqa: F401  (autouse)

H, W = 240, 320
FORCE_KEYS = ("volume_cm3", "contact_area_mm2", "max_depth_mm", "force_N")
STAT_KEYS = ("mean_C", "median_C", "std_C", "min_C", "max_C")


@pytest.fixture(scope="module")
def runs():
    jf, jt = scaled_ftp_config(H, W), scaled_temp_config(H, W)
    fcfg = ftp_config_from_dict(dataclasses.asdict(jf))
    tcfg = temp_config_from_dict(dataclasses.asdict(jt))
    ref_g, de_g = synthetic_pair(H, W, fcfg, seed=0)
    tlc = synthetic_tlc_frame(H, W, tcfg, seed=0)
    ref = gates.compose_multimodal_frame(ref_g, tlc)
    de = gates.compose_multimodal_frame(de_g, tlc)
    color, wide = synthetic_deploy_temp_weights(seed=0)
    jc, jw = (JaxWeights(**dataclasses.asdict(m)) for m in (color, wide))
    jres = JaxMultimodalPipeline(
        JaxForcePipeline(jf, JaxForceConfig(), gates.P2H, gates.FORCE, debug_outputs=True),
        JaxTemperaturePipeline(jt, jc, jw))(ref, de)

    force = ForcePipeline(fcfg, force_config_from_dict(dataclasses.asdict(JaxForceConfig())),
                          gates.P2H, gates.FORCE, debug_outputs=True, device="cpu")
    mm = MultimodalPipeline(force, TemperaturePipeline(tcfg, color, wide, device="cpu"))
    kernels.reset_launches()
    de_t = mm.ingest(de)
    seq = mm(ref, de_t)
    maps = mm.step_fused(ref, de_t, fetch="maps")
    scalars = mm.step_fused(ref, de, fetch="scalars")
    return dict(jres=jres, seq=seq, maps=maps, scalars=scalars, mm=mm, ref=ref, de=de,
                launches=dict(kernels.LAUNCHES))


def test_force_within_the_contract(runs):
    jres, tres = runs["jres"]["force"], runs["seq"]["force"]
    assert gates.force_gap(jres, tres) < 0.01
    for key in FORCE_KEYS:
        assert abs(tres[key] - jres[key]) <= 0.01 * abs(jres[key]), key
    gates.assert_carrier_bins_equal(jres, tres)
    assert gates.ecc_gap_px(jres, tres) < 0.05
    assert np.isfinite(tres["height_map_mm_crop"]).sum() > 0


def test_temperature_within_the_contract(runs):
    jres, tres = runs["jres"], runs["seq"]
    jt, tt = jres["temperature"], tres["temperature"]
    np.testing.assert_array_equal(tt["seg_peak_xy"], jt["seg_peak_xy"])
    js, ts = jres["temperature_stats"], tres["temperature_stats"]
    assert ts["valid_pixels"] > 0
    assert abs(ts["valid_pixels"] - js["valid_pixels"]) <= 0.005 * js["valid_pixels"]
    assert abs(ts["mean_C"] - js["mean_C"]) <= 0.1
    assert abs(ts["min_C"] - js["min_C"]) <= 0.75
    assert abs(ts["max_C"] - js["max_C"]) <= 0.75
    assert np.mean(tt["source_map"][tt["roi_outer"]] == 255) >= 0.01
    assert set(tt) == set(jt) and "chroma" in tt
    assert set(tres) == set(jres) == {"force", "temperature", "temperature_stats"}
    assert set(ts) == set(js)


def test_sequential_path_is_the_two_pipelines_alone(runs):
    mm, ref, de, seq = runs["mm"], runs["ref"], runs["de"], runs["seq"]
    for k, v in mm.force(ref, de, roi_from_finite=True).items():
        np.testing.assert_array_equal(seq["force"][k], v, err_msg=k)
    for k, v in mm.temperature(de).items():
        np.testing.assert_array_equal(seq["temperature"][k], v, err_msg=k)


def test_fused_maps_match_sequential(runs):
    seq, fus = runs["seq"], runs["maps"]
    f_s, f_f = seq["force"], fus["force"]
    assert set(f_f) == set(f_s)
    np.testing.assert_allclose(f_f["height_map_mm_crop"], f_s["height_map_mm_crop"],
                               rtol=1e-5, atol=1e-6, equal_nan=True)
    for k in (*FORCE_KEYS, "mm_per_px", "estimated_grating_period_px"):
        assert f_f[k] == pytest.approx(f_s[k], rel=1e-4, abs=1e-7), k
    t_s, t_f = seq["temperature"], fus["temperature"]
    assert set(t_f) == set(t_s)
    np.testing.assert_allclose(t_f["temperature_map_final"], t_s["temperature_map_final"],
                               rtol=1e-5, atol=1e-4, equal_nan=True)
    st_s, st_f = seq["temperature_stats"], fus["temperature_stats"]
    assert st_f["valid_pixels"] == st_s["valid_pixels"]
    for k in STAT_KEYS:
        assert st_f[k] == pytest.approx(st_s[k], abs=1e-3), k


def test_fused_scalar_fetch_and_no_launch_on_cpu(runs):
    sc, fus = runs["scalars"], runs["maps"]
    assert all(type(v) in (int, float) for v in sc.values()), sc
    for k in (*FORCE_KEYS, "mm_per_px"):
        assert sc[k] == pytest.approx(fus["force"][k], rel=1e-6, abs=1e-9), k
    st = fus["temperature_stats"]
    assert sc["valid_pixels"] == st["valid_pixels"] > 0
    for k in ("mean", "min", "max"):
        assert sc[f"t_{k}_C"] == pytest.approx(st[f"{k}_C"], abs=1e-3), k
    assert all(v == 0 for v in runs["launches"].values()), runs["launches"]
