"""Shared end-to-end comparison of the port's ForcePipeline with the JAX
ForcePipeline on the CPU, with the deploy contract's gates (imported by the
``test_torch_slice_*`` and ``test_torch_force4k`` files).

Both sides run ``synthetic_pair`` under the same configuration, carried
across with ``ftp_config_from_dict(dataclasses.asdict(jax_cfg))``.  The JAX
CPU run takes its XLA fallbacks (the histogram-ladder percentiles, the
plain PCG instead of K6, the LU-solve ECC loop, the non-fused polyfit),
while the port's CPU run walks the TPU route with its kernels' plain
versions, so the gates are the deploy contract's, not bit equality:
force within 1%, equal carrier bins, ECC warp within 0.05 px,
``reliable_crop`` agreement >= 99.5% of pixels.
"""
import dataclasses

import numpy as np

from vistaf_tpu.config import ForceConfig as JaxForceConfig
from vistaf_tpu.pipelines.force import ForcePipeline as JaxForcePipeline
from vistaf_tpu.utils.synthetic import synthetic_pair

from vistaf_torch import kernels
from vistaf_torch.config import force_config_from_dict, ftp_config_from_dict
from vistaf_torch.pipelines.force import ForcePipeline

P2H = {"type": "hinge_saturating",
       "params": {"a": 2.0826494996246554, "b": 4.20441143052732,
                  "c": -1.767844217125454e-09}}
FORCE = {"type": "growth", "params": {"a": 1.6197727931063521, "b": 9.756634595755994}}


def run_both(jcfg, seed=0):
    """(JAX result, port result, port launch counts) for one synthetic pair."""
    ref, de = synthetic_pair(jcfg.image_height, jcfg.image_width, jcfg, seed=seed)
    jres = JaxForcePipeline(jcfg, JaxForceConfig(), P2H, FORCE, debug_outputs=True)(ref, de)
    tcfg = ftp_config_from_dict(dataclasses.asdict(jcfg))
    fcfg = force_config_from_dict(dataclasses.asdict(JaxForceConfig()))
    kernels.reset_launches()
    tres = ForcePipeline(tcfg, fcfg, P2H, FORCE, debug_outputs=True, device="cpu")(ref, de)
    return jres, tres, dict(kernels.LAUNCHES)


def force_gap(jres, tres) -> float:
    assert np.isfinite(tres["force_N"]) and tres["force_N"] > 0
    return abs(tres["force_N"] - jres["force_N"]) / jres["force_N"]


def assert_carrier_bins_equal(jres, tres):
    for key in ("carrier_k_ref", "carrier_k_def"):
        np.testing.assert_array_equal(np.round(tres[key]), np.round(jres[key]))
    np.testing.assert_array_equal(np.round(tres["dbg_peak_ref"]), np.round(jres["dbg_peak_ref"]))


def ecc_gap_px(jres, tres) -> float:
    return float(np.abs(tres["dbg_ecc_warp"][:, 2] - jres["dbg_ecc_warp"][:, 2]).max())


def reliable_agreement(jres, tres) -> float:
    return float(np.mean(tres["reliable_crop"] == jres["reliable_crop"]))
