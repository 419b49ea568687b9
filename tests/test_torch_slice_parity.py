"""The parity preset end to end: the port's ForcePipeline against the JAX
ForcePipeline on the CPU at 640x480 under ``scaled_ftp_config(480, 640)``
(the CLI's default numerics, no ``deploy()``), with the gates of
``torch_slice_gates``.

Here both sides take the same algorithms: sort percentiles (bit-equal),
the gather-sampler ECC loop, the full-``fft2`` demod with the 'topk'
carrier search, the largest component, the unfolded plane removal, the
non-fused IRLS, the hole fill and the full-resolution PCG unwrap.  What
differs is summation order (XLA's against PyTorch's), the FFT library, and
the gather ECC's moments, which the port sums in float64 (JAX in float32).
Measured on a CPU (seed 0):
  - force 1.755583 N against JAX's 1.755553 N, a gap of 0.0017% (gate 1%),
  - equal carrier bins (and refined peaks within 1e-4 bin),
  - ECC warp within 0.009 px (gate 0.05 px), rho within 2.3e-5; 14
    iterations against JAX's 4 (rho gains ~2e-7 an iteration along ty,
    which the vertical grating leaves nearly flat, and JAX's float32 sums
    stop the loop at the first change below 1e-7),
  - reliable_crop and output_reliable_crop equal on every pixel (gate
    99.5%),
  - the global shift within 0.007 px (pocketfft against XLA's FFT under
    the whitened cross-power spectrum).
The knobs of the preset's neighbourhood that the port runs are each held to
JAX at 240x320 (``test_ported_parity_knobs_match_jax``); the ones it does
not run raise (``test_unported_parity_knobs_raise_by_name``).
"""
import dataclasses

import numpy as np
import pytest

from vistaf_tpu.config import FTPConfig as JaxFTPConfig
from vistaf_tpu.utils.synthetic import scaled_ftp_config

import torch_slice_gates as gates
from torch_threads import single_torch_thread  # noqa: F401  (autouse)
from vistaf_torch import config as tcfg
from vistaf_torch.ftp.pipeline import FTPGeometry, FTPPipeline, unwrap_route
from vistaf_torch.ops.unwrap import dense_dct_solve


@pytest.fixture(scope="module")
def runs():
    return gates.run_both(scaled_ftp_config(480, 640))


def test_force_within_one_percent(runs):
    jres, tres, _ = runs
    assert gates.force_gap(jres, tres) < 0.01
    for key in ("volume_cm3", "contact_area_mm2", "max_depth_mm"):
        assert abs(tres[key] - jres[key]) <= 0.01 * abs(jres[key]), key
    assert abs(tres["mm_per_px"] - jres["mm_per_px"]) < 1e-5 * jres["mm_per_px"]


def test_carrier_bins_equal(runs):
    jres, tres, _ = runs
    gates.assert_carrier_bins_equal(jres, tres)
    np.testing.assert_allclose(tres["dbg_peak_ref"], jres["dbg_peak_ref"], atol=1e-4)


def test_ecc_warp_within_tolerance(runs):
    jres, tres, _ = runs
    assert gates.ecc_gap_px(jres, tres) < 0.05
    assert abs(tres["dbg_ecc_rho"] - jres["dbg_ecc_rho"]) < 1e-4
    assert 1 <= int(tres["dbg_ecc_iters"]) < 300
    np.testing.assert_allclose(tres["dbg_global_shift"], jres["dbg_global_shift"], atol=0.02)


def test_reliable_mask_agrees(runs):
    jres, tres, _ = runs
    assert gates.reliable_agreement(jres, tres) >= 0.995
    assert np.mean(tres["output_reliable_crop"] == jres["output_reliable_crop"]) >= 0.995


def test_maps_agree(runs):
    """Stage by stage: the demodulated quality, the unwrapped and zeroed
    phase on the common reliable pixels, and the mm height map."""
    jres, tres, _ = runs
    roi = tres["roi_eroded_crop"]
    q_t, q_j = tres["dbg_quality"], jres["dbg_quality"]
    assert np.abs(q_t - q_j)[roi].max() < 1e-2 * np.abs(q_j[roi]).max()
    rel = tres["reliable_crop"] & jres["reliable_crop"]
    assert np.median(np.abs(tres["dbg_phase_zeroed"] - jres["dbg_phase_zeroed"])[rel]) < 1e-3
    hm_t, hm_j = tres["height_map_mm_crop"], jres["height_map_mm_crop"]
    np.testing.assert_array_equal(np.isfinite(hm_t), np.isfinite(hm_j))
    assert np.abs(hm_t - hm_j)[roi].max() < 0.02 * np.abs(hm_j[roi]).max()


def test_cpu_run_launched_nothing(runs):
    """On CPU tensors every wrapper takes its plain version."""
    assert all(v == 0 for v in runs[2].values()), runs[2]


def test_native_4k_parity_route_builds_on_the_cpu():
    """``FTPConfig()``: a 1182x1182 crop, unwrapped at full resolution by
    the plain PCG with the FFT-based DCT (no K6, no pooled grid); the
    pipeline passes its checks and builds on the CPU.  The scaled preset's
    236x236 crop takes the dense DCT."""
    for jc, crop, dense in ((JaxFTPConfig(), 1182, False),
                            (scaled_ftp_config(480, 640), 236, True)):
        cfg = tcfg.ftp_config_from_dict(dataclasses.asdict(jc))
        g = FTPGeometry.from_config(cfg)
        assert (g.crop_h, g.crop_w) == (crop, crop)
        assert unwrap_route(cfg, (crop, crop)) == ("plain", (crop, crop))
        assert dense_dct_solve((crop, crop)) == dense
        FTPPipeline.check_config(cfg)
    pipe = FTPPipeline(tcfg.FTPConfig(), gates.P2H, device="cpu")
    assert tuple(pipe.roi.shape) == (1182, 1182) and pipe.device.type == "cpu"


def _knob_run(change):
    """The JAX ForcePipeline and the port's on the 240x320 synthetic pair
    under ``scaled_ftp_config(240, 320)`` with the JAX prealignment test's
    reduced budgets and one knob changed: (JAX, the port free-running, the
    port given JAX's alignment)."""
    jc = scaled_ftp_config(240, 320).replace(
        ecc_iters=40, unwrap_cg_iters=8, inpaint_iters=8,
        grating_prealign_ecc_iters=40).replace(**change)
    jres, tres, launches = gates.run_both(jc)
    assert all(v == 0 for v in launches.values()), launches
    return jres, tres, gates.run_port_given_alignment(jc, jres)


# the ids these cases had while their knobs raised
@pytest.mark.parametrize("knob,change", [
    pytest.param("sideband_method", dict(sideband_method="gauss"),
                 id="sideband_method-change0"),
    pytest.param("lock_carrier_to_reference", dict(lock_carrier_to_reference=False),
                 id="lock_carrier_to_reference-change1"),
    pytest.param("use_hann_window", dict(use_hann_window=True), id="use_hann_window-change2"),
    pytest.param("ecc_warp_mode", dict(ecc_warp_mode="translation"), id="ecc_warp_mode-change3"),
    pytest.param("ecc_warp_mode", dict(ecc_warp_mode="affine"), id="ecc_warp_mode-change4"),
    pytest.param("ecc_sampler", dict(ecc_stride=2), id="ecc_sampler-change5"),
    pytest.param("use_two_pass_detrend", dict(use_two_pass_detrend=False),
                 id="use_two_pass_detrend-change9"),
    pytest.param("use_grating_band_prealign", dict(use_grating_band_prealign=True),
                 id="use_grating_band_prealign-change10"),
])
def test_ported_parity_knobs_match_jax(knob, change):
    """Each knob of the parity preset's neighbourhood that once raised here
    now builds, and its pipeline is held to JAX's at 240x320 with the gates
    of ``tests/test_torch_knobs.py``: the ECC warp free-running
    (translations 0.05 px, the rotation 5e-5 rad, an affine warp's linear
    part 5e-5 of each entry), the carrier peaks within 1e-3 bins, and given
    JAX's alignment (the grating leaves the ECC's ty nearly flat) force
    within 0.1% and the reliable mask equal on 99.9% of the pixels."""
    from test_torch_knobs import assert_pipeline_close
    jres, tres, given = _knob_run(change)
    assert_pipeline_close(jres, tres, given)
    if knob == "lock_carrier_to_reference":     # each frame keeps its own carrier
        assert not np.array_equal(tres["carrier_k_ref"], tres["carrier_k_def"])


@pytest.mark.parametrize("knob,change", [
    pytest.param("percentile_method", dict(percentile_method="hist"),
                 id="percentile_method-change6"),
    pytest.param("percentile_method", dict(percentile_method="hist_rows"),
                 id="percentile_method-change7"),
    pytest.param("percentile_method", dict(percentile_method="bisect"),
                 id="percentile_method-change8"),
    pytest.param("global_shift_downsample", dict(global_shift_downsample=2,
                                                 global_shift_downsample_min_px=0),
                 id="global_shift_downsample-change11"),
    pytest.param("global_shift_window_px", dict(global_shift_window_px=128),
                 id="global_shift_window_px-change12"),
])
def test_unported_parity_knobs_raise_by_name(knob, change):
    """What of the parity preset's neighbourhood is not ported raises at
    construction, naming the knob: the rejected global-shift knobs, and
    ``hist_rows`` and ``bisect``, which are not JAX percentile methods
    either.  The ``hist`` percentiles are ported (the JAX whole-limb tests'
    configuration): that case builds."""
    cfg = tcfg.ftp_config_from_dict(dataclasses.asdict(scaled_ftp_config(480, 640)))
    if change == {"percentile_method": "hist"}:
        pipe = FTPPipeline(cfg.replace(**change), gates.P2H, device="cpu")
        assert pipe.cfg.percentile_method == "hist"
        return
    with pytest.raises(NotImplementedError, match=knob):
        FTPPipeline(cfg.replace(**change), gates.P2H, device="cpu")
