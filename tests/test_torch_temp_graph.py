"""The temperature forward and the fused multimodal step as the card's CUDA
graphs capture them, on the CPU.

On the card ``TemperaturePipeline.forward`` replays one CUDA graph of
``forward_eager`` for each value of ``stats_only``, and
``MultimodalPipeline.fused_forward`` one of ``fused_forward_eager`` (both
forwards and the volume -> force reduction), as the JAX package jits them.
Here each eager forward runs after one warm-up call (the capture follows
one on the card) under the guard of ``torch_host_guard``: nothing read on
the host, nothing built from host values, every output bit-equal to the
unguarded call.  The temperature routes at ``scaled_temp_config(320,
640)``: the deploy preset (the shear fold, the rfft2 cascade, the matmul
bandpass, ``hist_pallas``, K8), the parity preset (the gather rotation,
fft2, top-k, the unfused models) and the deploy preset with one knob
changed at a time; the fused step at 240x320 under both presets.

The shear fold's ``lax.cond`` is two ``device_if`` on the fold's parity
(IF nodes under a capture): held to the JAX function at even and odd
quarter turns within 1e-3 degC on the finite pixels (as the gather route in
``test_torch_parity_ops_temp.py``), with exactly one blur a fold, and with
both bodies run under the guard after a warm-up that took one of them (the
other branch's band matrices are built outside its body).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vistaf_tpu.temperature import inference as jinf

from chip_smoke import FORCE_MODEL, P2H_MODEL, compose_multimodal_frame
from vistaf_torch.config import ForceConfig
from vistaf_torch.kernels import graph_cond_kernel
from vistaf_torch.ops.consts import DeviceConsts
from vistaf_torch.pipelines.force import ForcePipeline
from vistaf_torch.pipelines.multimodal import MultimodalPipeline
from vistaf_torch.temperature import inference
from vistaf_torch.temperature.inference import TemperaturePipeline
from vistaf_torch.utils.synthetic import (scaled_ftp_config, scaled_temp_config,
                                          synthetic_deploy_temp_weights, synthetic_pair,
                                          synthetic_tlc_frame)
from torch_host_guard import PLAIN_VERSIONS, no_host_reads, same_tensors
from torch_threads import single_torch_thread  # noqa: F401  (autouse)

T = torch.as_tensor

TEMP = scaled_temp_config(320, 640)
TEMP_ROUTES = {
    "deploy": TEMP.deploy(),
    "parity": TEMP,
    "seg_bandpass_fft": TEMP.deploy().replace(seg_bandpass="fft"),
    "percentile_sort": TEMP.deploy().replace(percentile_method="sort"),
    "percentile_hist": TEMP.deploy().replace(percentile_method="hist"),
    "no_crop_compute": TEMP.deploy().replace(crop_compute=False),
    "no_final_smooth": TEMP.deploy().replace(final_smooth_enable=False),
    "unfused_models": TEMP.deploy().replace(use_fused_kernel=False),
}


def multimodal(preset: str, h: int = 240, w: int = 320):
    fcfg, tcfg = scaled_ftp_config(h, w), scaled_temp_config(h, w)
    if preset == "deploy":
        fcfg, tcfg = fcfg.deploy(), tcfg.deploy()
    color, wide = synthetic_deploy_temp_weights(seed=0)
    mm = MultimodalPipeline(ForcePipeline(fcfg, ForceConfig(), P2H_MODEL, FORCE_MODEL,
                                          device="cpu"),
                            TemperaturePipeline(tcfg, color, wide, device="cpu"))
    ref_g, de_g = synthetic_pair(h, w, fcfg, seed=0)
    tlc = synthetic_tlc_frame(h, w, tcfg, seed=0)
    return (mm, mm.ingest(compose_multimodal_frame(ref_g, tlc)),
            mm.ingest(compose_multimodal_frame(de_g, tlc)))


@pytest.mark.parametrize("stats_only", [False, True], ids=["maps", "stats"])
@pytest.mark.parametrize("route", list(TEMP_ROUTES))
def test_temperature_forward_reads_nothing_on_the_host(monkeypatch, route, stats_only):
    cfg = TEMP_ROUTES[route]
    color, wide = synthetic_deploy_temp_weights(seed=0)
    pipe = TemperaturePipeline(cfg, color, wide, device="cpu")
    x = pipe.upload(synthetic_tlc_frame(320, 640, cfg, seed=0))
    want = pipe.forward_eager(x, stats_only)
    with no_host_reads(monkeypatch, PLAIN_VERSIONS):
        got = pipe.forward_eager(x, stats_only)
    same_tensors(got, want)
    assert pipe.forward(x, stats_only).keys() == want.keys()


@pytest.mark.parametrize("stats_only", [False, True], ids=["maps", "scalars"])
@pytest.mark.parametrize("preset", ["deploy", "parity"])
def test_fused_multimodal_forward_reads_nothing_on_the_host(monkeypatch, preset, stats_only):
    mm, r, d = multimodal(preset)
    want = mm.fused_forward_eager(r, d, stats_only)
    with no_host_reads(monkeypatch, PLAIN_VERSIONS):
        got = mm.fused_forward_eager(r, d, stats_only)
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        same_tensors(a, b)
    assert float(got[2]["force_N"]) > 0.0


def test_graph_route_only_on_the_card():
    color, wide = synthetic_deploy_temp_weights(seed=0)
    for cfg in (TEMP.deploy(), TEMP, TEMP_ROUTES["unfused_models"]):
        pipe = TemperaturePipeline(cfg, color, wide, device="cpu")
        assert not pipe.graph_route()
        pipe.device = torch.device("cuda")      # the route rule alone; nothing runs
        assert pipe.graph_route()


@pytest.mark.parametrize("force_kw,want", [
    ({}, True), ({"debug_outputs": True}, False), ({"stop_after": "unwrap"}, False)],
    ids=["plain", "debug", "stop_after"])
def test_multimodal_graph_route_needs_both_routes(force_kw, want):
    mm, _, _ = multimodal("deploy")
    for k, v in force_kw.items():
        setattr(mm.force.ftp, k, v)
    assert not mm.graph_route()
    mm.force.ftp.device = mm.temperature.device = torch.device("cuda")  # the rule alone
    assert mm.graph_route() is want


def _fold_inputs(rng):
    h, w = 72, 104
    yy, xx = np.mgrid[0:h, 0:w]
    roi = (yy - 36) ** 2 + (xx - 52) ** 2 <= 30 ** 2
    m = (25.0 + 0.05 * xx + 0.1 * yy + rng.normal(scale=0.5, size=(h, w))).astype(np.float32)
    m[~roi] = np.nan
    m[30:34, 40:44] = np.nan
    return m, roi


@pytest.mark.parametrize("vpu", [False, True], ids=["matmul", "shift_add"])
@pytest.mark.parametrize("angle_deg", [20.0, 70.0, 100.0, -95.0, 185.0])
def test_shear_fold_matches_jax_with_one_blur(monkeypatch, angle_deg, vpu):
    """``angle_deg`` is the fold's (the stripe angle negated, in degrees):
    its quarter-turn count is 0, 1, 1, -1 and 2."""
    m, roi = _fold_inputs(np.random.default_rng(0))
    angle_rad = np.float32(-angle_deg * np.pi / 180.0)
    want = np.asarray(jinf.oriented_gaussian_blur(
        jnp.asarray(m), jnp.asarray(roi), jnp.float32(angle_rad), 3.0, 0.8, method="shear",
        vpu=vpu))
    blurs = []
    real = inference.gaussian_blur

    def counted(*a, **k):
        blurs.append(a[1:2])
        return real(*a, **k)
    monkeypatch.setattr(inference, "gaussian_blur", counted)
    got = inference.oriented_gaussian_blur(T(m), T(roi), torch.tensor(angle_rad), 3.0, 0.8,
                                           DeviceConsts("cpu"), method="shear",
                                           vpu=vpu).numpy()
    assert len(blurs) == 1, blurs
    odd = round(angle_deg / 90.0) % 2 == 1
    assert blurs[0] == ((0.8,) if odd else (3.0,))
    assert np.array_equal(np.isfinite(got), np.isfinite(want))
    f = np.isfinite(want)
    assert f.mean() > 0.3
    np.testing.assert_allclose(got[f], want[f], rtol=0, atol=1e-3)


@pytest.mark.parametrize("vpu", [False, True], ids=["matmul", "shift_add"])
def test_both_fold_bodies_read_nothing_on_the_host(monkeypatch, vpu):
    """After a warm-up that took the even branch, both ``device_if`` bodies
    run under the guard (the predicate forced true): neither reads the host
    or builds a constant, as a capture after that warm-up needs."""
    m, roi = _fold_inputs(np.random.default_rng(1))
    consts = DeviceConsts("cpu")
    args = (T(m), T(roi), torch.tensor(np.float32(-0.2)), 3.0, 0.8, consts)
    inference.oriented_gaussian_blur(*args, method="shear", vpu=vpu)
    built = set(consts._cache)
    with no_host_reads(monkeypatch, PLAIN_VERSIONS):
        monkeypatch.setattr(graph_cond_kernel, "set_conditional_plain", lambda pred: True)
        inference.oriented_gaussian_blur(*args, method="shear", vpu=vpu)
    assert set(consts._cache) == built
