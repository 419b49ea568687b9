"""The ported 640x480 frame->force slice against the JAX ForcePipeline.

Both sides run ``synthetic_pair(480, 640)`` under the slice config (the
deploy preset with ``unwrap_method='wls'``) on the CPU.  The JAX CPU run
takes its XLA fallbacks (the histogram-ladder percentiles instead of the
bisection kernel, the LU-solve ECC loop, the non-fused polyfit), while the
port's CPU run takes the plain versions of its kernels, so the gates are
the deploy contract's, not bit equality:
  - force within 1% (measured gap 0.08%),
  - equal carrier bins,
  - ECC warp within 0.05 px (measured 0.018 px),
  - reliable_crop agreement >= 99.5% of pixels (measured 1 pixel of 55,696).
Intermediate stages (debug outputs) are compared where they help to find a
divergence.
"""
import dataclasses

import numpy as np
import pytest

from vistaf_tpu.config import ForceConfig as JaxForceConfig
from vistaf_tpu.pipelines.force import ForcePipeline as JaxForcePipeline
from vistaf_tpu.utils.synthetic import scaled_ftp_config, synthetic_pair

from vistaf_torch import kernels
from vistaf_torch.config import force_config_from_dict, ftp_config_from_dict
from vistaf_torch.ftp.pipeline import FTPPipeline
from vistaf_torch.pipelines.force import ForcePipeline
from torch_threads import single_torch_thread  # noqa: F401  (autouse)

P2H = {"type": "hinge_saturating",
       "params": {"a": 2.0826494996246554, "b": 4.20441143052732,
                  "c": -1.767844217125454e-09}}
FORCE = {"type": "growth", "params": {"a": 1.6197727931063521, "b": 9.756634595755994}}


@pytest.fixture(scope="module")
def runs():
    jcfg = scaled_ftp_config(480, 640).deploy().replace(unwrap_method="wls")
    ref, de = synthetic_pair(480, 640, jcfg)
    jres = JaxForcePipeline(jcfg, JaxForceConfig(), P2H, FORCE, debug_outputs=True)(ref, de)
    tcfg = ftp_config_from_dict(dataclasses.asdict(jcfg))
    fcfg = force_config_from_dict(dataclasses.asdict(JaxForceConfig()))
    kernels.reset_launches()
    tpipe = ForcePipeline(tcfg, fcfg, P2H, FORCE, debug_outputs=True, device="cpu")
    tres = tpipe(ref, de)
    return jres, tres, tpipe, (ref, de)


def test_force_within_deploy_contract(runs):
    jres, tres, _, _ = runs
    gap = abs(tres["force_N"] - jres["force_N"]) / jres["force_N"]
    assert np.isfinite(tres["force_N"]) and tres["force_N"] > 0
    assert gap < 0.01, (tres["force_N"], jres["force_N"])
    for key in ("volume_cm3", "contact_area_mm2", "max_depth_mm"):
        assert abs(tres[key] - jres[key]) <= 0.01 * abs(jres[key]), key
    assert abs(tres["mm_per_px"] - jres["mm_per_px"]) < 1e-5 * jres["mm_per_px"]


def test_carrier_bins_equal(runs):
    jres, tres, _, _ = runs
    for key in ("carrier_k_ref", "carrier_k_def"):
        np.testing.assert_array_equal(np.round(tres[key]), np.round(jres[key]))
        np.testing.assert_allclose(tres[key], jres[key], atol=1e-4)
    np.testing.assert_array_equal(np.round(tres["dbg_peak_ref"]), np.round(jres["dbg_peak_ref"]))


def test_alignment_within_tolerance(runs):
    jres, tres, _, _ = runs
    # the global phase-correlation shift: whitened spectra amplify FFT
    # rounding differences (pocketfft vs XLA), measured 0.006 px
    np.testing.assert_allclose(tres["dbg_global_shift"], jres["dbg_global_shift"], atol=0.02)
    np.testing.assert_allclose(tres["dbg_ecc_warp"][:, 2], jres["dbg_ecc_warp"][:, 2],
                               atol=0.05)
    assert abs(tres["dbg_ecc_rho"] - jres["dbg_ecc_rho"]) < 1e-4
    # aligned crop: sub-0.05 px warp differences on 0-255 data
    a, b = tres["dbg_def_gray_aligned"], jres["dbg_def_gray_aligned"]
    assert np.abs(a - b).max() < 2.0 and np.abs(a - b).mean() < 0.1


def test_masks_and_maps_agree(runs):
    jres, tres, _, _ = runs
    roi = tres["roi_eroded_crop"]
    np.testing.assert_array_equal(roi, jres["roi_eroded_crop"])
    assert np.mean(tres["reliable_crop"] == jres["reliable_crop"]) >= 0.995
    assert np.mean(tres["output_reliable_crop"] == jres["output_reliable_crop"]) >= 0.995
    # demodulated amplitude and quality: bad-pixel thresholds differ by
    # percentile method, the rest is f32 rounding
    q_t, q_j = tres["dbg_quality"], jres["dbg_quality"]
    assert np.abs(q_t - q_j)[roi].max() < 1e-2 * np.abs(q_j[roi]).max()
    rel = tres["reliable_crop"] & jres["reliable_crop"]
    d = np.abs(tres["dbg_phase_zeroed"] - jres["dbg_phase_zeroed"])[rel]
    assert np.median(d) < 1e-2
    hm_t, hm_j = tres["height_map_mm_crop"], jres["height_map_mm_crop"]
    np.testing.assert_array_equal(np.isfinite(hm_t), np.isfinite(hm_j))
    assert np.abs(hm_t - hm_j)[roi].max() < 0.02 * np.abs(hm_j[roi]).max()


def test_stop_after_stages_match_the_full_run(runs):
    _, tres, tpipe, (ref, de) = runs
    cfg = tpipe.ftp.cfg
    for stage, key in (("align", "dbg_def_gray_aligned"), ("detrend", "dbg_phase_zeroed")):
        cut = FTPPipeline(cfg, P2H, stop_after=stage, device="cpu")(ref, de)
        np.testing.assert_array_equal(cut["x"], tres[key])
    with pytest.raises(ValueError):
        FTPPipeline(cfg, P2H, stop_after="nope", device="cpu")


def test_cpu_run_used_the_plain_versions(runs):
    """On CPU tensors every wrapper takes its plain version: no launch."""
    assert all(v == 0 for v in kernels.LAUNCHES.values())
