"""The 640x480 slice under the deploy preset as shipped,
``scaled_ftp_config(480, 640).deploy()``, against the JAX ForcePipeline on
the CPU.  The port's CPU run walks the TPU route: K1, K3, K5, K6 and K7
by their plain versions, with no override of the preset.

Gates (``torch_slice_gates``): force within 1% (measured 0.080%), equal
carrier bins, ECC warp within 0.05 px (measured 0.018 px),
``reliable_crop`` agreement >= 99.5% (measured 1 pixel of 55,696), and no
kernel launch on the CPU.
"""
import numpy as np
import pytest
import torch

from vistaf_tpu.utils.synthetic import scaled_ftp_config

from vistaf_torch.ftp.pipeline import FTPPipeline
from vistaf_torch.kernels import unwrap_kernel
from vistaf_torch.ops.consts import DeviceConsts

import torch_slice_gates as gates
from torch_threads import single_torch_thread  # noqa: F401  (autouse)


@pytest.fixture(scope="module")
def runs():
    return gates.run_both(scaled_ftp_config(480, 640).deploy())


def test_force_within_deploy_contract(runs):
    jres, tres, _ = runs
    assert gates.force_gap(jres, tres) < 0.01
    for key in ("volume_cm3", "contact_area_mm2", "max_depth_mm"):
        assert abs(tres[key] - jres[key]) <= 0.01 * abs(jres[key]), key


def test_carrier_bins_equal(runs):
    gates.assert_carrier_bins_equal(*runs[:2])


def test_ecc_warp_within_tolerance(runs):
    jres, tres, _ = runs
    assert gates.ecc_gap_px(jres, tres) < 0.05
    assert abs(tres["dbg_ecc_rho"] - jres["dbg_ecc_rho"]) < 1e-4


def test_reliable_mask_agrees(runs):
    jres, tres, _ = runs
    assert gates.reliable_agreement(jres, tres) >= 0.995
    assert np.mean(tres["output_reliable_crop"] == jres["output_reliable_crop"]) >= 0.995


def test_unwrap_took_the_k6_route(runs):
    """The shipped preset's unwrap is K6 (``wls_pallas`` inside its budget):
    the pipeline's unwrapped phase is K6's plain version on the same input."""
    _, tres, _ = runs
    assert unwrap_kernel.fits(tres["phase_wrapped_crop"].shape)
    cfg = gates.ftp_config_from_dict(
        gates.dataclasses.asdict(scaled_ftp_config(480, 640).deploy()))
    want = unwrap_kernel.unwrap_wls_plain(torch.as_tensor(tres["phase_wrapped_crop"]),
                                          torch.as_tensor(tres["reliable_crop"]),
                                          DeviceConsts("cpu"), cfg.unwrap_cg_iters,
                                          cfg.unwrap_cg_tol).numpy()
    np.testing.assert_array_equal(tres["dbg_unwrapped"], want)
    assert FTPPipeline(cfg, gates.P2H, device="cpu").cfg.unwrap_method == "wls_pallas"


def test_cpu_run_launched_nothing(runs):
    assert all(v == 0 for v in runs[2].values()), runs[2]
