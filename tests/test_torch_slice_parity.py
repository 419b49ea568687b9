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


@pytest.mark.parametrize("knob,change", [
    ("sideband_method", dict(sideband_method="gauss")),
    ("lock_carrier_to_reference", dict(lock_carrier_to_reference=False)),
    ("use_hann_window", dict(use_hann_window=True)),
    ("ecc_warp_mode", dict(ecc_warp_mode="translation")),
    ("ecc_warp_mode", dict(ecc_warp_mode="affine")),
    ("ecc_sampler", dict(ecc_stride=2)),
    ("percentile_method", dict(percentile_method="hist")),
    ("percentile_method", dict(percentile_method="hist_rows")),
    ("percentile_method", dict(percentile_method="bisect")),
    ("use_two_pass_detrend", dict(use_two_pass_detrend=False)),
    ("use_grating_band_prealign", dict(use_grating_band_prealign=True)),
    ("global_shift_downsample", dict(global_shift_downsample=2,
                                     global_shift_downsample_min_px=0)),
    ("global_shift_window_px", dict(global_shift_window_px=128)),
])
def test_unported_parity_knobs_raise_by_name(knob, change):
    """What of the parity preset's neighbourhood is still not ported raises
    at construction, naming the knob; the rejected global-shift knobs stay
    excluded.  The ``hist`` percentiles are ported (the JAX whole-limb
    tests' configuration): that case builds; ``hist_rows`` and ``bisect``,
    which are not JAX percentile methods either, keep raising."""
    cfg = tcfg.ftp_config_from_dict(dataclasses.asdict(scaled_ftp_config(480, 640)))
    if change == {"percentile_method": "hist"}:
        pipe = FTPPipeline(cfg.replace(**change), gates.P2H, device="cpu")
        assert pipe.cfg.percentile_method == "hist"
        return
    with pytest.raises(NotImplementedError, match=knob):
        FTPPipeline(cfg.replace(**change), gates.P2H, device="cpu")
