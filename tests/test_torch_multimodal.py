"""The port's MultimodalPipeline against the JAX MultimodalPipeline on the
CPU, at a small deploy size both packages run: ``scaled_ftp_config(240,
320).deploy()`` and ``scaled_temp_config(240, 320).deploy()`` with the
deploy weights' form (``synthetic_deploy_temp_weights``), on one frame
pair that carries both the grating and thermochromic colour
(``torch_slice_gates.compose_multimodal_frame``).

The JAX side runs ``__call__`` with its fused temperature kernel in
interpret mode (``_fused_fn``, as ``test_torch_slice_temp.py`` does) and
its force forward's XLA fallbacks; the port's CPU run walks the card's
route with its kernels' plain versions.  Gates, the deploy contracts:
force, volume, area and depth within 1%, equal carrier bins; temperature
t_mean within 0.1 degC, t_min and t_max within 0.75 degC, valid pixels
within 0.5%, equal stripe carrier, COLOR on >= 1% of the ROI.  Within the
port, ``step_fused`` is held to ``__call__`` with the tolerances of
``test_multimodal_fused.py`` (height map rtol 1e-5 atol 1e-6, scalars rel
1e-4, temperature map atol 1e-4, stats 1e-3 degC), its scalar fetch to its
map fetch at rel 1e-6, and the sequential path to the two pipelines run
alone, bit for bit.

The JAX force forward compiled for that call also serves, so that no other
JAX graph of the forward compiles (a compile costs ~40 s alone and several
times that under the 6-worker suite):

- ``ForcePipeline``'s surfaces: the JAX surfaces' own tails run on the JAX
  call's heightmap and period (their forward replaced by those outputs);
  the port's tails on the same heightmap must match bit for bit for masks
  and depths, at rel 1e-6 for the area, at rel 1e-5 where a float32 exp or
  a reordered sum enters (force, force map).  The port's surfaces end to
  end on the frames are held to those JAX results within the deploy
  contract (force, area and the reductions within 1%, contact masks
  agreeing on >= 99.5% of pixels), its evidence scalars to its own
  ``__call__`` at rel 1e-6.
- ``BatchedForce``: two streams against the JAX ``BatchedForce._single``
  on each stream (the function ``batched()`` vmaps) run with that compiled
  forward: force, volume and area within 1% (the deploy contract), the
  one-pixel max depth within 2% (measured 1.5%).
"""
import copy
import dataclasses
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vistaf_tpu.calib.temp_weights import TempModelWeights as JaxWeights
from vistaf_tpu.config import ForceConfig as JaxForceConfig
from vistaf_tpu.pallas.temp_kernel import make_fused_temperature_fn
from vistaf_tpu.parallel.mesh import BatchedForce as JaxBatchedForce
from vistaf_tpu.pipelines.force import ForcePipeline as JaxForcePipeline
from vistaf_tpu.pipelines.multimodal import MultimodalPipeline as JaxMultimodalPipeline
from vistaf_tpu.temperature.inference import TemperaturePipeline as JaxTemperaturePipeline
from vistaf_tpu.utils.synthetic import scaled_ftp_config, scaled_temp_config, synthetic_pair

from vistaf_torch import kernels
from vistaf_torch.config import (force_config_from_dict, ftp_config_from_dict,
                                 temp_config_from_dict)
from vistaf_torch.parallel.mesh import BatchedForce
from vistaf_torch.pipelines import force as port_force
from vistaf_torch.pipelines.force import ForcePipeline
from vistaf_torch.pipelines.multimodal import MultimodalPipeline
from vistaf_torch.temperature.inference import TemperaturePipeline
from vistaf_torch.utils.synthetic import synthetic_deploy_temp_weights, synthetic_tlc_frame

import torch_slice_gates as gates
from torch_threads import single_torch_thread  # noqa: F401  (autouse)

H, W = 240, 320
EPS = 0.01
FORCE_KEYS = ("volume_cm3", "contact_area_mm2", "max_depth_mm", "force_N")
STAT_KEYS = ("mean_C", "median_C", "std_C", "min_C", "max_C")


def _frames(fcfg, tcfg):
    ref, de = synthetic_pair(H, W, fcfg, seed=0)
    tlc = synthetic_tlc_frame(H, W, tcfg, seed=0)
    return (gates.compose_multimodal_frame(ref, tlc),
            gates.compose_multimodal_frame(de, tlc))


@pytest.fixture(scope="module")
def runs():
    jf, jt = scaled_ftp_config(H, W).deploy(), scaled_temp_config(H, W).deploy()
    fcfg = ftp_config_from_dict(dataclasses.asdict(jf))
    tcfg = temp_config_from_dict(dataclasses.asdict(jt))
    ref, de = _frames(fcfg, tcfg)
    color, wide = synthetic_deploy_temp_weights(seed=0)
    jc, jw = (JaxWeights(**dataclasses.asdict(m)) for m in (color, wide))
    jtemp = JaxTemperaturePipeline(jt, jc, jw)
    jtemp._fused_fn = make_fused_temperature_fn(jt, jc, jw, interpret=True)
    jforce = JaxForcePipeline(jf, JaxForceConfig(), gates.P2H, gates.FORCE, debug_outputs=True)
    jres = JaxMultimodalPipeline(jforce, jtemp)(ref, de)

    force = ForcePipeline(fcfg, force_config_from_dict(dataclasses.asdict(JaxForceConfig())),
                          gates.P2H, gates.FORCE, debug_outputs=True, device="cpu")
    mm = MultimodalPipeline(force, TemperaturePipeline(tcfg, color, wide, device="cpu"))
    kernels.reset_launches()
    de_t = mm.ingest(de)
    seq = mm(ref, de_t)
    maps = mm.step_fused(ref, de_t, fetch="maps")
    scalars = mm.step_fused(ref, de, fetch="scalars")
    return dict(jres=jres, seq=seq, maps=maps, scalars=scalars, mm=mm, ref=ref, de=de,
                launches=dict(kernels.LAUNCHES), jforce=jforce, fcfg=fcfg)


def test_force_within_deploy_contract(runs):
    jres, tres = runs["jres"]["force"], runs["seq"]["force"]
    assert gates.force_gap(jres, tres) < 0.01
    for key in FORCE_KEYS:
        assert abs(tres[key] - jres[key]) <= 0.01 * abs(jres[key]), key
    gates.assert_carrier_bins_equal(jres, tres)
    assert gates.ecc_gap_px(jres, tres) < 0.05
    # the orchestrator's ROI convention: every finite heightmap cell
    assert np.isfinite(tres["height_map_mm_crop"]).sum() > 0


def test_temperature_within_deploy_contract(runs):
    jres, tres = runs["jres"], runs["seq"]
    jt, tt = jres["temperature"], tres["temperature"]
    np.testing.assert_array_equal(tt["seg_peak_xy"], jt["seg_peak_xy"])
    js, ts = jres["temperature_stats"], tres["temperature_stats"]
    assert ts["valid_pixels"] > 0
    assert abs(ts["valid_pixels"] - js["valid_pixels"]) <= 0.005 * js["valid_pixels"]
    assert abs(ts["mean_C"] - js["mean_C"]) <= 0.1
    assert abs(ts["min_C"] - js["min_C"]) <= 0.75
    assert abs(ts["max_C"] - js["max_C"]) <= 0.75
    # the scene drives both models: COLOR wins on a real share of the ROI
    assert np.mean(tt["source_map"][tt["roi_outer"]] == 255) >= 0.01
    assert set(tres) == set(jres) == {"force", "temperature", "temperature_stats"}
    assert set(ts) == set(js)


def test_sequential_path_is_the_two_pipelines_alone(runs):
    mm, ref, de, seq = runs["mm"], runs["ref"], runs["de"], runs["seq"]
    alone = mm.force(ref, de, roi_from_finite=True)
    for k, v in alone.items():
        np.testing.assert_array_equal(seq["force"][k], v, err_msg=k)
    temp = mm.temperature(de)
    for k, v in temp.items():
        np.testing.assert_array_equal(seq["temperature"][k], v, err_msg=k)


def test_fused_maps_match_sequential(runs):
    seq, fus = runs["seq"], runs["maps"]
    f_s, f_f = seq["force"], fus["force"]
    assert set(f_f) == set(f_s)
    np.testing.assert_allclose(f_f["height_map_mm_crop"], f_s["height_map_mm_crop"],
                               rtol=1e-5, atol=1e-6, equal_nan=True)
    assert f_f["estimated_grating_period_px"] == pytest.approx(
        f_s["estimated_grating_period_px"], rel=1e-6)
    for k in (*FORCE_KEYS, "mm_per_px"):
        assert f_f[k] == pytest.approx(f_s[k], rel=1e-4, abs=1e-7), k
    t_s, t_f = seq["temperature"], fus["temperature"]
    assert set(t_f) == set(t_s)
    np.testing.assert_allclose(t_f["temperature_map_final"], t_s["temperature_map_final"],
                               rtol=1e-5, atol=1e-4, equal_nan=True)
    assert np.array_equal(t_f["mask_roi_eff"], t_s["mask_roi_eff"])
    st_s, st_f = seq["temperature_stats"], fus["temperature_stats"]
    assert st_f["valid_pixels"] == st_s["valid_pixels"]
    for k in STAT_KEYS:
        assert st_f[k] == pytest.approx(st_s[k], abs=1e-3), k


def test_fused_scalar_fetch(runs):
    """fetch='scalars' returns plain Python numbers that agree with the map
    fetch's reductions; the numpy deformed frame was uploaded by it."""
    sc, fus = runs["scalars"], runs["maps"]
    assert all(type(v) in (int, float) for v in sc.values()), sc
    assert type(sc["valid_pixels"]) is int
    for k in (*FORCE_KEYS, "mm_per_px"):
        assert sc[k] == pytest.approx(fus["force"][k], rel=1e-6, abs=1e-9), k
    st = fus["temperature_stats"]
    assert sc["valid_pixels"] == st["valid_pixels"] > 0
    assert sc["t_mean_C"] == pytest.approx(st["mean_C"], abs=1e-3)
    assert sc["t_min_C"] == pytest.approx(st["min_C"], abs=1e-3)
    assert sc["t_max_C"] == pytest.approx(st["max_C"], abs=1e-3)
    assert sc["estimated_grating_period_px"] == pytest.approx(
        fus["force"]["estimated_grating_period_px"], rel=1e-6)


def test_cpu_run_launched_nothing(runs):
    assert all(v == 0 for v in runs["launches"].values()), runs["launches"]


def test_ingest_passes_device_tensors_through(runs):
    mm, de = runs["mm"], runs["de"]
    t = mm.ingest(de)
    assert t.device.type == "cpu" and t.dtype == torch.uint8
    np.testing.assert_array_equal(t.numpy(), de)
    assert mm.ingest(t) is t
    assert mm.force.ftp.upload(t) is t
    assert mm.temperature.upload(t) is t


def test_contract_errors(runs):
    mm = runs["mm"]
    with pytest.raises(ValueError, match="fetch"):
        mm.step_fused(runs["ref"], runs["de"], fetch="everything")
    other = TemperaturePipeline.__new__(TemperaturePipeline)
    other.device = torch.device("meta")
    with pytest.raises(ValueError, match="one device"):
        MultimodalPipeline(mm.force, other)


# ----------------------------------------------------------------------
# ForcePipeline's surfaces on the JAX call's heightmap
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def surfaces(runs):
    """The JAX ForcePipeline with its forward replaced by the call's
    heightmap and period, and the port's tail inputs from the same."""
    jf = runs["jres"]["force"]
    cached = {"height_map_mm_crop": jnp.asarray(jf["height_map_mm_crop"]),
              "est_period_px": jnp.float32(jf["estimated_grating_period_px"])}
    jpipe = copy.copy(runs["jforce"])
    jpipe.ftp = copy.copy(jpipe.ftp)
    jpipe.ftp._forward_impl = lambda r, d: cached
    pipe = runs["mm"].force
    height = torch.as_tensor(np.array(jf["height_map_mm_crop"]))
    period = torch.tensor(jf["estimated_grating_period_px"], dtype=torch.float32)
    return jpipe, pipe, height, pipe.mm_per_px_device(period)


def test_contact_classification_tail_matches_jax(surfaces):
    jpipe, _, height, mm = surfaces
    contact, area, depth = port_force.contact_classification(height, mm, EPS)
    jc, ja, jd = jpipe.contact_classification_device()(None, None)
    np.testing.assert_array_equal(contact.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(depth.numpy(), np.asarray(jd))
    assert float(area) == pytest.approx(float(ja), rel=1e-6)
    assert contact.any()


def test_force_map_tail_matches_jax(surfaces):
    jpipe, _, height, mm = surfaces
    fmap, disp, f = port_force.force_map(height, mm, EPS, gates.FORCE)
    jm, jdisp, jf = jpipe.force_map_device()(None, None)
    np.testing.assert_array_equal(disp.numpy(), np.asarray(jdisp))
    assert float(f) == pytest.approx(float(jf), rel=1e-5)
    np.testing.assert_allclose(fmap.numpy(), np.asarray(jm), rtol=1e-5, atol=1e-12)
    # the map spreads the scalar force over the patch and sums to it
    assert float(fmap.sum()) == pytest.approx(float(f), rel=1e-5)


@pytest.mark.parametrize("roi_from_finite", [False, True])
def test_evidence_surface_matches_jax(runs, surfaces, roi_from_finite):
    """The port's surface end to end against the JAX tail on the JAX
    heightmap (deploy contract), and its host tail against its own
    ``__call__``."""
    jpipe, pipe, *_ = surfaces
    ref, de = runs["ref"], runs["de"]
    fn = pipe.evidence_reductions_device(roi_from_finite)
    red = fn(ref, de)
    assert red.shape == (4,) and red.dtype == torch.float32
    js, jn, jd, jp = (float(x) for x in jpipe.evidence_reductions_device(roi_from_finite)(
        None, None))
    s, n, d, p = red.tolist()
    assert p == pytest.approx(jp, rel=1e-4)
    for a, b in ((s, js), (n, jn), (d, jd)):
        assert a == pytest.approx(b, rel=0.01)
    ev = pipe.evidence_scalars(ref, de, fn)
    assert all(type(v) is float for v in ev.values())
    call = runs["seq"]["force"] if roi_from_finite else pipe(ref, de)
    for k in ("volume_cm3", "contact_area_mm2", "max_depth_mm", "force_N", "mm_per_px",
              "estimated_grating_period_px"):
        assert ev[k] == pytest.approx(call[k], rel=1e-6), k
    jev = jpipe.evidence_scalars(None, None, jpipe.evidence_reductions_device(roi_from_finite))
    assert ev["force_N"] == pytest.approx(jev["force_N"], rel=0.01)


def test_device_surfaces_end_to_end(runs, surfaces):
    """Frames in, device tensors out, within the deploy contract of the JAX
    surfaces on the JAX heightmap."""
    jpipe, pipe, *_ = surfaces
    ref, de = runs["ref"], runs["de"]
    contact, area, depth = pipe.contact_classification_device()(ref, de)
    jc, ja, _ = jpipe.contact_classification_device()(None, None)
    assert contact.shape == np.asarray(jc).shape and contact.dtype == torch.bool
    assert np.mean(contact.numpy() == np.asarray(jc)) >= 0.995
    assert float(area) == pytest.approx(float(ja), rel=0.01)
    fmap, disp, f = pipe.force_map_device()(ref, de)
    _, _, jf = jpipe.force_map_device()(None, None)
    assert float(f) == pytest.approx(float(jf), rel=0.01)
    assert float(fmap.sum()) == pytest.approx(float(f), rel=1e-5)
    assert all(t.device.type == "cpu" for t in (contact, area, depth, fmap, disp, f))


# ----------------------------------------------------------------------
# BatchedForce on two streams against the JAX BatchedForce._single
# ----------------------------------------------------------------------
def test_batched_force_within_deploy_contract(runs):
    fcfg = runs["fcfg"]
    pairs = [synthetic_pair(H, W, fcfg, dent_depth_rad=d, seed=s)
             for s, d in ((0, 0.8), (1, 0.5))]
    refs = np.stack([p[0] for p in pairs])
    frames = np.stack([p[1] for p in pairs])
    jb = JaxBatchedForce(types.SimpleNamespace(_forward_impl=runs["jforce"].ftp._forward),
                         gates.FORCE)
    jouts = [jb._single(refs[b], frames[b]) for b in range(2)]
    kernels.reset_launches()
    out = BatchedForce(runs["mm"].force.ftp, gates.FORCE).batched()(refs, frames)
    assert all(v == 0 for v in kernels.LAUNCHES.values()), kernels.LAUNCHES
    assert set(out) == set(jouts[0])
    for k, rtol in (("force_N", 0.01), ("volume_cm3", 0.01), ("contact_area_mm2", 0.01),
                    ("max_depth_mm", 0.02)):
        assert out[k].shape == (2,) and out[k].dtype == torch.float32
        np.testing.assert_allclose(out[k].numpy(), [float(j[k]) for j in jouts], rtol=rtol,
                                   err_msg=k)
    assert out["height_map_mm"].shape == (2, *np.asarray(jouts[0]["height_map_mm"]).shape)
    assert (out["force_N"] > 0).all()
