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


def run_port_given_alignment(jcfg, jres, seed=0):
    """The port's result on the same pair given JAX's alignment: the global
    shift and the crop ECC's warp are JAX's (``phase_correlate`` and
    ``FTPPipeline._ecc`` return them, as ``chip_smoke.same_alignment`` gives
    the CPU the card's); every later stage, a prealignment's own ECC
    included, runs as it runs.  On the synthetic grating the ECC's ty is
    nearly flat, so free-running ports and JAX stop up to 0.05 px apart
    there, which the force then follows."""
    import torch
    from vistaf_torch.ftp import pipeline as tpipe
    ref, de = synthetic_pair(jcfg.image_height, jcfg.image_width, jcfg, seed=seed)
    shift = torch.as_tensor(np.array(jres["dbg_global_shift"]))
    ecc = tuple(torch.as_tensor(np.array(jres[k])) for k in ("dbg_ecc_warp", "dbg_ecc_rho",
                                                    "dbg_ecc_iters"))
    saved = tpipe.phase_correlate, tpipe.FTPPipeline._ecc
    tpipe.phase_correlate = lambda a, b, win: (shift[0], shift[1], torch.zeros(()))
    tpipe.FTPPipeline._ecc = lambda self, crop01: ecc
    try:
        tcfg = ftp_config_from_dict(dataclasses.asdict(jcfg))
        fcfg = force_config_from_dict(dataclasses.asdict(JaxForceConfig()))
        return ForcePipeline(tcfg, fcfg, P2H, FORCE, debug_outputs=True, device="cpu")(ref, de)
    finally:
        tpipe.phase_correlate, tpipe.FTPPipeline._ecc = saved


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


def compose_multimodal_frame(grating_bgr, tlc_bgr):
    """A frame of a skin that carries both patterns, for the multimodal
    paths (neither ``synthetic_pair`` nor ``synthetic_tlc_frame`` draws
    both): the thermochromic frame's colour, each pixel's BGR minus its
    gray, over the grating frame's gray, rounded and clipped to uint8.  Its
    gray is the grating's up to the clipping, so FTP locks on the grating
    carrier; the temperature path segments that grating as its stripes
    and reads the thermochromic colours on them."""
    t = tlc_bgr.astype(np.float32)
    lum = 0.114 * t[..., 0] + 0.587 * t[..., 1] + 0.299 * t[..., 2]
    g = grating_bgr[..., 0].astype(np.float32)
    return np.clip(np.round(t + (g - lum)[..., None]), 0, 255).astype(np.uint8)
