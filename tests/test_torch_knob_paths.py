"""Two force knobs off the presets' path through the multi-stream and the
multimodal entry points, in the port against the JAX package on the CPU at
240x320 (the JAX tests' reduced budgets, as ``test_torch_knobs.py``):

- the unlocked per-frame demod with the grating-band prealignment under the
  deploy preset, two streams through ``BatchedForce.batched()``, against
  the JAX ``BatchedForce`` (its vmapped ``_single``, one compile);
- the Hann window under the deploy preset through
  ``MultimodalPipeline.step_fused(fetch="scalars")`` over the deploy
  temperature preset, against the JAX ``MultimodalPipeline.__call__`` (its
  fused temperature kernel in interpret mode).

Gates, ``torch_slice_gates.run_port_given_alignment``'s: given JAX's
global shift and ECC warp (every later stage, the prealignment's own ECC
included, runs as it runs) the force, volume, contact area and depth
within 1% (the deploy contract), the finite heightmap pixels equal
(BatchedForce); the port's own ECC, solved from JAX's shift, within 0.05 px
of JAX's warp wherever JAX's solve stopped before its 40-iteration cap;
and the temperature half within its contract: t_mean within 0.1 degC,
t_min and t_max within 0.75 degC, valid pixels within 0.5%.

Measured (one PyTorch thread, as the suite runs): given JAX's alignment the
unlocked streams' forces 0.17% and 0.05% from JAX's, the Hann path's 0.15%.
The unlocked quality map rounds one pixel of the first stream's reliable
mask the other way (its quality 9e-9 from JAX's, at the threshold); given
JAX's mask too, that stream's gap falls to 2.5e-5 (both measured against
the JAX ``ForcePipeline`` of the stream).  On the second stream
JAX's ECC runs to its cap (ty 2.39 px) and the port's own solve follows
the reduction order: 40 iterations to within 1e-4 px of JAX under one
thread, 12 iterations to ty 0.69 px under eight; a capped solve reached no
minimizer, so it is not held.  Free-running, that stream's global shift
lands 0.69 px from JAX's in x, and its force 2.8% from JAX's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vistaf_tpu.calib import scalar_models as jscalar
from vistaf_tpu.calib.temp_weights import TempModelWeights as JaxWeights
from vistaf_tpu.config import ForceConfig as JaxForceConfig
from vistaf_tpu.ftp.pipeline import FTPPipeline as JaxFTPPipeline
from vistaf_tpu.pallas.temp_kernel import make_fused_temperature_fn
from vistaf_tpu.parallel import mesh as jmesh
from vistaf_tpu.pipelines.force import ForcePipeline as JaxForcePipeline
from vistaf_tpu.pipelines.force import depth_map_to_volume_cm3 as j_volume
from vistaf_tpu.pipelines.multimodal import MultimodalPipeline as JaxMultimodalPipeline
from vistaf_tpu.temperature.inference import TemperaturePipeline as JaxTemperaturePipeline
from vistaf_tpu.utils.synthetic import scaled_ftp_config, scaled_temp_config, synthetic_pair

import vistaf_torch.ftp.pipeline as tpipe
from vistaf_torch import kernels
from vistaf_torch.config import (force_config_from_dict, ftp_config_from_dict,
                                 temp_config_from_dict)
from vistaf_torch.ftp.pipeline import FTPPipeline
from vistaf_torch.parallel import mesh as tmesh
from vistaf_torch.pipelines.force import ForcePipeline
from vistaf_torch.pipelines.multimodal import MultimodalPipeline
from vistaf_torch.temperature.inference import TemperaturePipeline
from vistaf_torch.utils.synthetic import synthetic_deploy_temp_weights, synthetic_tlc_frame

import torch_slice_gates as gates
from torch_threads import single_torch_thread  # noqa: F401  (autouse)

T = torch.as_tensor
H, W = 240, 320
BUDGETS = dict(ecc_iters=40, unwrap_cg_iters=8, inpaint_iters=8, grating_prealign_ecc_iters=40)
CONTRACT_RTOL, ECC_ATOL_PX = 0.01, 0.05
ALIGNMENT = ("dbg_global_shift", "dbg_ecc_warp", "dbg_ecc_rho", "dbg_ecc_iters")
STREAMS = ((0, 0.8), (1, 0.5))          # (seed, dent depth in rad) a stream


def J(a):
    """A writable numpy copy (JAX hands out read-only buffers)."""
    return np.array(a)


def given(alignment, own):
    """While the block runs, every port FTPPipeline takes the global shift
    and ECC warp ``alignment()`` returns (keys of ``ALIGNMENT``, numpy; a
    batched forward's stacked a stream), solving its own ECC too, appended
    to ``own``."""
    saved = tpipe.phase_correlate, tpipe.FTPPipeline._ecc

    def ecc(pipe, crop01, **stream_kw):
        own.append(saved[1](pipe, crop01, **stream_kw))
        return tuple(T(alignment()[k]) for k in ALIGNMENT[1:])

    def correlate(a, b, win, **stream_kw):
        shift = T(alignment()["dbg_global_shift"])
        return shift[..., 0], shift[..., 1], torch.zeros(shift.shape[:-1])

    class Patch:
        def __enter__(self):
            tpipe.phase_correlate, tpipe.FTPPipeline._ecc = correlate, ecc

        def __exit__(self, *exc):
            tpipe.phase_correlate, tpipe.FTPPipeline._ecc = saved
    return Patch()


# --------------------------------------------------------------- BatchedForce
class _JaxAlignedForce(jmesh.BatchedForce):
    """JAX's ``BatchedForce._single`` with the stream's alignment beside its
    results."""

    def _single(self, ref_bgr, def_bgr):
        res = self.pipe._forward_impl(ref_bgr, def_bgr)
        height = res["height_map_mm_crop"]
        mm_per_px = self.grating_pitch_mm / jnp.maximum(res["est_period_px"], 1e-9)
        v, a, d = j_volume(height, jnp.isfinite(height), mm_per_px, self.depth_eps_mm)
        return {"force_N": jscalar.predict_force_from_volume(self.force_model, v),
                "volume_cm3": v, "contact_area_mm2": a, "max_depth_mm": d,
                "height_map_mm": height, **{k: res[k] for k in ALIGNMENT}}


@pytest.fixture(scope="module")
def streams():
    jc = scaled_ftp_config(H, W).deploy().replace(**BUDGETS).replace(
        lock_carrier_to_reference=False, use_grating_band_prealign=True)
    tc = ftp_config_from_dict(dataclasses.asdict(jc))
    pairs = [synthetic_pair(H, W, jc, seed=s, dent_depth_rad=d) for s, d in STREAMS]
    refs, defs = np.stack([p[0] for p in pairs]), np.stack([p[1] for p in pairs])
    jbf = _JaxAlignedForce(JaxFTPPipeline(jc, gates.P2H, debug_outputs=True), gates.FORCE)
    jres = {k: J(v) for k, v in jax.jit(jbf.batched())(refs, defs).items()}
    kernels.reset_launches()
    free = tmesh.BatchedForce(FTPPipeline(tc, gates.P2H, device="cpu"),
                              gates.FORCE).batched()(refs, defs)
    # the batched forward given each stream's JAX alignment, its own ECC
    # solved beside it (one batched solve, split a stream)
    own = []
    with given(lambda: {n: jres[n] for n in ALIGNMENT}, own):
        aligned = tmesh.BatchedForce(FTPPipeline(tc, gates.P2H, device="cpu"),
                                     gates.FORCE).batched()(refs, defs)
    (solved,) = own
    return dict(jres=jres, free={k: v.numpy() for k, v in free.items()},
                aligned={k: v.numpy() for k, v in aligned.items()},
                own=[tuple(x[i] for x in solved) for i in range(len(STREAMS))],
                launches=dict(kernels.LAUNCHES))


def test_unlocked_prealign_batched_force_given_alignment(streams):
    jres, got = streams["jres"], streams["aligned"]
    assert got["force_N"].shape == (len(STREAMS),)
    for k in ("force_N", "volume_cm3", "contact_area_mm2", "max_depth_mm"):
        np.testing.assert_allclose(got[k], jres[k], rtol=CONTRACT_RTOL, err_msg=k)
    np.testing.assert_array_equal(np.isfinite(got["height_map_mm"]),
                                  np.isfinite(jres["height_map_mm"]))
    assert (jres["force_N"] > 0).all()


def test_unlocked_prealign_own_ecc_and_free_run(streams):
    """Each stream's own ECC from JAX's shift within 0.05 px of JAX's warp
    where JAX's solve stopped before its cap (the first stream); the
    free-running batch launches nothing on the CPU and is finite."""
    jres = streams["jres"]
    assert len(streams["own"]) == len(STREAMS)
    converged = jres["dbg_ecc_iters"] < BUDGETS["ecc_iters"]
    assert converged[0], jres["dbg_ecc_iters"]
    for (warp, _, _), jw, ok in zip(streams["own"], jres["dbg_ecc_warp"], converged):
        if ok:
            assert np.abs(warp.numpy() - jw)[:, 2].max() < ECC_ATOL_PX
    assert all(v == 0 for v in streams["launches"].values()), streams["launches"]
    assert np.isfinite(streams["free"]["force_N"]).all()


# --------------------------------------------------------------- step_fused
@pytest.fixture(scope="module")
def multimodal():
    jf = scaled_ftp_config(H, W).deploy().replace(**BUDGETS).replace(use_hann_window=True)
    jt = scaled_temp_config(H, W).deploy()
    fcfg = ftp_config_from_dict(dataclasses.asdict(jf))
    tcfg = temp_config_from_dict(dataclasses.asdict(jt))
    ref_g, de_g = synthetic_pair(H, W, jf, seed=0)
    tlc = synthetic_tlc_frame(H, W, tcfg, seed=0)
    ref, de = (gates.compose_multimodal_frame(g, tlc) for g in (ref_g, de_g))
    color, wide = synthetic_deploy_temp_weights(seed=0)
    jc, jw = (JaxWeights(**dataclasses.asdict(m)) for m in (color, wide))
    jtemp = JaxTemperaturePipeline(jt, jc, jw)
    jtemp._fused_fn = make_fused_temperature_fn(jt, jc, jw, interpret=True)
    jforce = JaxForcePipeline(jf, JaxForceConfig(), gates.P2H, gates.FORCE, debug_outputs=True)
    jres = JaxMultimodalPipeline(jforce, jtemp)(ref, de)
    force = ForcePipeline(fcfg, force_config_from_dict(dataclasses.asdict(JaxForceConfig())),
                          gates.P2H, gates.FORCE, device="cpu")
    mm = MultimodalPipeline(force, TemperaturePipeline(tcfg, color, wide, device="cpu"))
    own = []
    with given(lambda: {k: J(jres["force"][k]) for k in ALIGNMENT}, own):
        scalars = mm.step_fused(ref, de, fetch="scalars")
    return dict(jres=jres, scalars=scalars, own=own)


def test_hann_step_fused_given_alignment(multimodal):
    jf, sc = multimodal["jres"]["force"], multimodal["scalars"]
    for k in ("force_N", "volume_cm3", "contact_area_mm2", "max_depth_mm"):
        assert abs(sc[k] - jf[k]) <= CONTRACT_RTOL * abs(jf[k]), (k, sc[k], jf[k])
    (warp, _, _), = multimodal["own"]
    assert np.abs(warp.numpy() - J(jf["dbg_ecc_warp"]))[:, 2].max() < ECC_ATOL_PX


def test_hann_step_fused_temperature_within_contract(multimodal):
    js, sc = multimodal["jres"]["temperature_stats"], multimodal["scalars"]
    assert sc["valid_pixels"] > 0
    assert abs(sc["valid_pixels"] - js["valid_pixels"]) <= 0.005 * js["valid_pixels"]
    assert abs(sc["t_mean_C"] - js["mean_C"]) <= 0.1
    assert abs(sc["t_min_C"] - js["min_C"]) <= 0.75
    assert abs(sc["t_max_C"] - js["max_C"]) <= 0.75
