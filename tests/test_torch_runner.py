"""The port's runner (``vistaf_torch/runner``: ``io``, ``figures``,
``debug_artifacts``, ``session``) and its ``utils/logging`` and
``utils/profiling`` against the JAX package's on the CPU.

- io: from the same result dict and arrays, ``write_force_result``,
  ``export_heightmap_files`` and ``write_mask_png`` write the same bytes as
  the JAX writers (``result.json``, ``result.csv``, ``.npy``, heightmap
  ``.csv``, mask PNGs); ``_bundle.npz`` holds the same keys and arrays.
- figures and debug artifacts: given the same numpy arrays every writer
  writes the same files, with equal decoded pixels; ``write_ftp_debug`` on a
  port ``FTPPipeline(debug_outputs=True, device="cpu")`` result writes the
  JAX contract's ``FTP_DEBUG_SET``, the temperature writers ``TEMP_DEBUG_SET``
  and ``TEMP_RAW_SET``.
- session: ``run_session`` of both packages with ``timestamp="TEST"`` on the
  scene of ``test_torch_multimodal_parity.py`` (``scaled_ftp_config(240,
  320)``, ``scaled_temp_config(240, 320)``, the deploy weights' form, the
  composed frame): equal relative trees; summary JSON with the same keys and
  JSON types and an equal ``calibration_performance``; ``sensor_readings``
  within that test's gates (``torch_runner_gates``); the same heightmap
  bundle keys; mask PNGs decoded equal.  The port's sequential and
  ``fused_step`` sessions against each other: readings within
  ``test_multimodal_fused.py``'s tolerances.
"""
import dataclasses
import json
import math
import os

import cv2
import numpy as np
import pytest
import torch

from vistaf_tpu.calib.temp_weights import TempModelWeights as JaxWeights
from vistaf_tpu.config import ForceConfig as JaxForceConfig
from vistaf_tpu.config import SessionConfig as JaxSessionConfig
from vistaf_tpu.pipelines.force import ForcePipeline as JaxForcePipeline
from vistaf_tpu.pipelines.multimodal import MultimodalPipeline as JaxMultimodalPipeline
from vistaf_tpu.runner import debug_artifacts as jdbg
from vistaf_tpu.runner import figures as jfig
from vistaf_tpu.runner import io as jio
from vistaf_tpu.runner import session as jsession
from vistaf_tpu.temperature.inference import TemperaturePipeline as JaxTemperaturePipeline
from vistaf_tpu.utils import logging as jlog
from vistaf_tpu.utils import profiling as jprof
from vistaf_tpu.utils.synthetic import scaled_ftp_config, scaled_temp_config

from vistaf_torch import config as tconfig
from vistaf_torch.calib import artifacts
from vistaf_torch.config import (SessionConfig, force_config_from_dict, ftp_config_from_dict,
                                 temp_config_from_dict)
from vistaf_torch.ftp.pipeline import FTPPipeline
from vistaf_torch.pipelines.force import ForcePipeline
from vistaf_torch.pipelines.multimodal import MultimodalPipeline
from vistaf_torch.runner import debug_artifacts as tdbg
from vistaf_torch.runner import figures as tfig
from vistaf_torch.runner import io as tio
from vistaf_torch.runner import session as tsession
from vistaf_torch.temperature.inference import TemperaturePipeline
from vistaf_torch.utils import logging as tlog
from vistaf_torch.utils import profiling as tprof
from vistaf_torch.utils.synthetic import (synthetic_deploy_temp_weights, synthetic_pair,
                                          synthetic_tlc_frame)

import chip_smoke
import torch_runner_gates as rg
import torch_slice_gates as gates
from test_debug_artifacts import FTP_DEBUG_SET, TEMP_DEBUG_SET, TEMP_RAW_SET
from torch_threads import single_torch_thread  # noqa: F401  (autouse)

H, W = 240, 320
BEST_MODEL = {**gates.FORCE, "equation": "F = a * (exp(b V) - 1)", "rmse": 6.9, "r2": 0.77,
              "n_fit": 40, "n_samples": 48}


def _both(fn_name, jmod, tmod, tmp_path, *args, **kw):
    """Run the same writer of both packages into tmp_path/{jax,torch};
    returns the two directories."""
    dirs = []
    for tag, mod in (("jax", jmod), ("torch", tmod)):
        d = tmp_path / tag
        d.mkdir(exist_ok=True)
        getattr(mod, fn_name)(str(d), *args, **kw)
        dirs.append(d)
    return dirs


def _assert_same_bytes(dj, dt):
    assert rg.tree(dj) == rg.tree(dt)
    for rel in rg.tree(dj):
        assert rg.read_bytes(dj / rel) == rg.read_bytes(dt / rel), rel


# ---------------------------------------------------------------------------
# io
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("period", [12.000123456789, None, float("nan")])
def test_write_force_result_same_bytes(tmp_path, monkeypatch, period):
    result = {"estimated_grating_period_px": period, "mm_per_px": 0.041666238,
              "volume_cm3": np.float32(0.0161532), "contact_area_mm2": 51.25,
              "max_depth_mm": np.float32(0.356668), "force_N": 0.27649312}
    best = dict(BEST_MODEL) if period is not None else {"params": {"a": 1.0}}
    dj, dt = (tmp_path / t for t in ("jax", "torch"))
    for d, mod in ((dj, jio), (dt, tio)):
        d.mkdir()
        monkeypatch.chdir(d)       # the output directory's name is in the JSON
        mod.write_force_result("out", result, best, "in/ref.png", "in/def.png",
                               "out/ftp_run", 1.5, 0.01)
    _assert_same_bytes(dj, dt)
    assert rg.tree(dt) == {"out/result.json", "out/result.csv"}
    assert tio.FORCE_CSV_FIELDS == jio.FORCE_CSV_FIELDS


@pytest.mark.parametrize("kind", ["crop_only", "full_masks_meta"])
def test_export_heightmap_files_same_bytes(tmp_path, kind):
    rng = np.random.default_rng(0)
    crop = rng.normal(size=(37, 41)).astype(np.float32)
    crop[rng.random(crop.shape) > 0.8] = np.nan
    kw = {}
    if kind == "full_masks_meta":
        full = np.full((60, 80), np.nan, np.float32)
        full[5:42, 11:52] = crop
        kw = dict(height_full=full,
                  crop_masks={"roi_eroded": np.isfinite(crop), "reliable": crop > 0},
                  full_masks={"roi": np.isfinite(full)},
                  meta={"crop_x1": np.int32(11), "crop_y1": np.int32(5)},
                  save_full_csv=True)
    dj, dt = _both("export_heightmap_files", jio, tio, tmp_path, "height_map", crop, **kw)
    assert rg.tree(dj) == rg.tree(dt)
    for rel in rg.tree(dj):
        if rel.endswith(".npz"):
            with np.load(dj / rel) as a, np.load(dt / rel) as b:
                assert sorted(a.files) == sorted(b.files)
                for k in a.files:
                    assert a[k].dtype == b[k].dtype, k
                    np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert rg.read_bytes(dj / rel) == rg.read_bytes(dt / rel), rel


@pytest.mark.parametrize("bbox", [None, (3, 40, 10, 70)])
def test_write_mask_png_and_crop2d(tmp_path, bbox):
    rng = np.random.default_rng(1)
    mask = rng.random((60, 80)) > 0.5
    for mod in (jio, tio):
        mod.write_mask_png(str(tmp_path / f"{mod.__name__}.png"), mask, bbox)
    a, b = (tmp_path / f"{m.__name__}.png" for m in (jio, tio))
    assert rg.read_bytes(a) == rg.read_bytes(b)
    want = jio.crop2d(mask, bbox)
    np.testing.assert_array_equal(tio.crop2d(mask, bbox), want)
    np.testing.assert_array_equal(rg.png(b), want.astype(np.uint8) * 255)


def test_imread_bgr_and_safe_float(tmp_path):
    img = np.random.default_rng(2).integers(0, 256, (30, 50, 3), dtype=np.uint8)
    p = str(tmp_path / "frame.png")
    cv2.imwrite(p, img)
    np.testing.assert_array_equal(tio.imread_bgr(p), jio.imread_bgr(p))
    np.testing.assert_array_equal(tio.imread_bgr(p), img)
    with pytest.raises(RuntimeError):
        tio.imread_bgr(str(tmp_path / "missing.png"))
    for x in (1, "2.5", np.float32(0.25), float("nan"), float("inf"), None, "x"):
        for fb in (float("nan"), -1.0):
            a, b = tio.safe_float(x, fb), jio.safe_float(x, fb)
            assert a == b or (math.isnan(a) and math.isnan(b)), (x, fb, a, b)
    tio.ensure_dir(str(tmp_path / "a" / "b"))
    assert os.path.isdir(tmp_path / "a" / "b")


# ---------------------------------------------------------------------------
# figures
# ---------------------------------------------------------------------------

def _figure_inputs():
    rng = np.random.default_rng(3)
    yy, xx = np.mgrid[0:48, 0:64].astype(np.float32)
    circ = (yy - 24) ** 2 + (xx - 32) ** 2 <= 20 ** 2
    height = np.where(circ, -0.3 * np.exp(-((yy - 24) ** 2 + (xx - 30) ** 2) / 60.0), np.nan)
    tmap = (20.0 + 13.0 * rng.random((48, 64))).astype(np.float32)
    img = rng.integers(0, 256, (48, 64, 3), dtype=np.uint8)
    return dict(circ=circ, height=height.astype(np.float32), phase=xx * 0.1 - yy * 0.05,
                tmap=tmap, img=img)


FIGURES = {
    "phase_and_height_panel": lambda m, d, a: m.save_phase_and_height_panel(
        d, a["phase"], a["height"], a["circ"]),
    "temperature_colormap": lambda m, d, a: m.save_temperature_colormap(
        d, a["tmap"], a["circ"], "tmap.png", 20.0, 33.0),
    "temperature_colormap_titled": lambda m, d, a: m.save_temperature_colormap(
        d, a["tmap"], a["circ"], "tmap_titled.png", 20.0, 75.0,
        title="Temperature map - min: 20.00 °C, max: 33.00 °C"),
    "temperature_overlay": lambda m, d, a: m.save_temperature_overlay(
        d, a["img"], a["tmap"], a["circ"], "overlay.png", 20.0, 33.0),
    "horizontal_legend": lambda m, d, a: m.save_horizontal_legend(d, 20.0, 75.0),
    "heightmap_3d": lambda m, d, a: m.save_heightmap_3d(
        d, a["height"], np.isfinite(a["height"]), "3D Heightmap - Force: 0.28 N"),
    "force_shape_right_panel": lambda m, d, a: m.save_force_shape_right_panel(
        d, a["height"], 0.2765),
}


@pytest.mark.parametrize("name", sorted(FIGURES))
def test_figure_writer_same_pixels(tmp_path, name):
    a = _figure_inputs()
    paths = []
    for tag, mod in (("jax", jfig), ("torch", tfig)):
        d = tmp_path / tag
        d.mkdir()
        paths.append(FIGURES[name](mod, str(d), a))
    dj, dt = tmp_path / "jax", tmp_path / "torch"
    assert os.path.relpath(paths[0], dj) == os.path.relpath(paths[1], dt)
    assert rg.tree(dj) == rg.tree(dt) and len(rg.tree(dt)) == 1
    rg.assert_same_pngs(dj, dt, rg.tree(dj))


def test_show_heightmap_3d_interactive_headless():
    import matplotlib
    matplotlib.use("Agg", force=True)
    hm = np.zeros((40, 50), np.float32)
    hm[10:20, 10:20] = -0.5
    tfig.show_heightmap_3d_interactive(hm, np.isfinite(hm), "test")  # must not block


# ---------------------------------------------------------------------------
# the scene: configurations, frames, the port's pipelines on the CPU
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    jf, jt = scaled_ftp_config(H, W), scaled_temp_config(H, W)
    fcfg = ftp_config_from_dict(dataclasses.asdict(jf))
    tcfg = temp_config_from_dict(dataclasses.asdict(jt))
    ref_g, de_g = synthetic_pair(H, W, fcfg, seed=0)
    tlc = synthetic_tlc_frame(H, W, tcfg, seed=0)
    ref = gates.compose_multimodal_frame(ref_g, tlc)
    de = gates.compose_multimodal_frame(de_g, tlc)
    color, wide = synthetic_deploy_temp_weights(seed=0)
    root = tmp_path_factory.mktemp("scene")
    paths = {}
    for name, frame in (("ref", ref), ("def", de)):
        paths[name] = str(root / f"{name}.png")
        assert cv2.imwrite(paths[name], frame)
    force_cfg = force_config_from_dict(dataclasses.asdict(JaxForceConfig()))
    mm = MultimodalPipeline(ForcePipeline(fcfg, force_cfg, gates.P2H, gates.FORCE,
                                          device="cpu"),
                            TemperaturePipeline(tcfg, color, wide, device="cpu"))
    return dict(jf=jf, jt=jt, fcfg=fcfg, tcfg=tcfg, ref=ref, de=de, color=color, wide=wide,
                paths=paths, root=root, mm=mm)


# ---------------------------------------------------------------------------
# debug artifacts
# ---------------------------------------------------------------------------

def test_write_ftp_debug_writes_the_jax_set(scene, tmp_path):
    pipe = FTPPipeline(scene["fcfg"], gates.P2H, debug_outputs=True, device="cpu")
    res = pipe(*synthetic_pair(H, W, scene["fcfg"], seed=0))
    assert {k for k in res if k.startswith("dbg_")} >= {
        "dbg_i_norm_ref", "dbg_i_norm_def", "dbg_amp_ref", "dbg_amp_def", "dbg_phase_ref",
        "dbg_phase_def", "dbg_unwrapped", "dbg_ref_gray", "dbg_def_gray_aligned"}
    dj, dt = _both("write_ftp_debug", jdbg, tdbg, tmp_path, res, scene["fcfg"],
                   apo=pipe._apo, log_lines=["[TEST] synthetic run"])
    files = rg.tree(dt)
    assert FTP_DEBUG_SET <= files, FTP_DEBUG_SET - files
    assert files == rg.tree(dj)
    assert rg.read_bytes(dt / "debug_log.txt") == rg.read_bytes(dj / "debug_log.txt")
    assert "grating period" in (dt / "debug_log.txt").read_text()
    rg.assert_same_pngs(dj, dt, files - {"debug_log.txt"})


@pytest.fixture(scope="module")
def temp_result(scene):
    return scene["mm"].temperature(scene["de"])


def test_write_temperature_debug_writes_the_jax_set(scene, temp_result, tmp_path):
    bbox = temp_result["crop_bbox"]
    dj, dt = _both("write_temperature_debug", jdbg, tdbg, tmp_path, scene["de"], temp_result,
                   bbox=bbox)
    files = rg.tree(dt)
    assert files == rg.tree(dj) == TEMP_DEBUG_SET
    rg.assert_same_pngs(dj, dt, files)
    y0, y1, x0, x1 = bbox
    assert rg.png(dt / "debug_seg_overlay.png").shape[:2] == (y1 - y0, x1 - x0)


def test_write_temperature_raw_maps_writes_the_jax_set(scene, temp_result, tmp_path):
    bbox = temp_result["crop_bbox"]
    dj, dt = _both("write_temperature_raw_maps", jdbg, tdbg, tmp_path, scene["de"],
                   temp_result, scene["tcfg"], bbox=bbox)
    files = rg.tree(dt)
    assert files == rg.tree(dj) == TEMP_RAW_SET
    rg.assert_same_pngs(dj, dt, files)


# ---------------------------------------------------------------------------
# session
# ---------------------------------------------------------------------------

def _write_data_root(root):
    """The force calibrations and the four metric blocks the summary reads."""
    artifacts.save_json(os.path.join(root, tconfig.PHASE_TO_HEIGHT_JSON), {
        "best_model": {**gates.P2H, "equation": "h = hinge(x)", "r2": 0.999, "rmse": 0.002,
                       "n": 120},
        "use_negated_height_for_fit": True, "x_definition": "unwrapped phase (rad)"})
    artifacts.save_json(os.path.join(root, tconfig.HEIGHT_TO_FORCE_JSON), {
        "best_model": BEST_MODEL, "volume_definition": "sum(depth * px area)"})
    block = {"rmse_C": 0.41, "mae_C": 0.3, "r2": 0.98, "max_abs_err_C": 2.5,
             "p95_abs_err_C": 0.9, "n": 5000}
    model = {"degree": 2, "equation": "T = poly(L, a, b)", "metrics_frames": block,
             "metrics_means": {**block, "n": 12}}
    artifacts.save_json(os.path.join(root, tconfig.TEMP_COLOR_METRICS_JSON),
                        {"models_final": {"heating": model, "global": model}})
    artifacts.save_json(os.path.join(root, tconfig.TEMP_BLACK_METRICS_JSON),
                        {"models_final": {"cooling": {**model, "degree": 3}}})


@pytest.fixture(scope="module")
def sessions(scene):
    """Session trees under scene root / {jax, torch, torch_fused, jax_nofig,
    torch_nofig}, the summaries, and the port's direct pipeline call."""
    root, p = scene["root"], scene["paths"]
    data_root = str(root / "data")
    _write_data_root(data_root)
    jc, jw = (JaxWeights(**dataclasses.asdict(m)) for m in (scene["color"], scene["wide"]))
    jmm = JaxMultimodalPipeline(
        JaxForcePipeline(scene["jf"], JaxForceConfig(), gates.P2H, BEST_MODEL),
        JaxTemperaturePipeline(scene["jt"], jc, jw))
    force_cfg = force_config_from_dict(dataclasses.asdict(JaxForceConfig()))
    mm = MultimodalPipeline(ForcePipeline(scene["fcfg"], force_cfg, gates.P2H, BEST_MODEL,
                                          device="cpu"), scene["mm"].temperature)
    runs = {
        "jax": (jsession.run_session, jmm, JaxSessionConfig, {}),
        "jax_nofig": (jsession.run_session, jmm, JaxSessionConfig,
                      {"save_summary_figures": False}),
        "torch": (tsession.run_session, mm, SessionConfig, {"show_3d_interactive": True}),
        "torch_fused": (tsession.run_session, mm, SessionConfig, {"fused_step": True}),
        "torch_nofig": (tsession.run_session, mm, SessionConfig,
                        {"save_summary_figures": False}),
    }
    shown, out = [], {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tfig, "show_heightmap_3d_interactive", lambda *a, **k: shown.append(a))
        for tag, (run, pipe, cfg_cls, kw) in runs.items():
            cfg = cfg_cls(output_root=str(root / tag), **kw)
            out[tag] = run(pipe, p["ref"], p["def"], data_root, cfg, timestamp="TEST")
    return dict(summaries=out, shown=shown, direct=mm(scene["ref"], scene["de"]),
                dirs={tag: root / tag / "session_TEST" for tag in runs},
                roots={tag: str(root / tag) for tag in runs})


def test_session_trees_equal(sessions):
    d = sessions["dirs"]
    assert rg.tree(d["torch"]) == rg.tree(d["jax"]) == rg.tree(d["torch_fused"])
    assert rg.tree(d["torch_nofig"]) == rg.tree(d["jax_nofig"]) == set(chip_smoke.SESSION_FILES)
    assert rg.tree(d["jax"]) > rg.tree(d["jax_nofig"])
    assert len(sessions["shown"]) == 1          # show_3d_interactive reaches the viewer


@pytest.mark.parametrize("tag", ["torch", "torch_fused", "torch_nofig"])
def test_session_summary_json(sessions, tag):
    s, r = sessions["summaries"], sessions["roots"]
    jax_tag = "jax_nofig" if tag == "torch_nofig" else "jax"
    got = rg.load_json(sessions["dirs"][tag] / "combined_outputs" / "multimodal_summary.json")
    want = rg.load_json(sessions["dirs"][jax_tag] / "combined_outputs"
                        / "multimodal_summary.json")
    assert got == json.loads(json.dumps(s[tag]))     # the file is the returned summary
    g, w = rg.normalise(got, r[tag]), rg.normalise(want, r[jax_tag])
    rg.assert_same_types(g, w)
    assert g["calibration_performance"] == w["calibration_performance"]
    assert g["calibration_performance"]["temperature_black_model"]["heating"] == {}
    rg.assert_readings_within_gates(g.pop("sensor_readings"), w.pop("sensor_readings"))
    assert g == w                  # ids, inputs, directories and file paths


def test_session_readings_are_the_direct_call(sessions):
    """The sequential session reports the pipeline's own numbers; the fused
    one within test_multimodal_fused.py's tolerances of them."""
    direct = sessions["direct"]
    for tag, rel, atol in (("torch", 0.0, 0.0), ("torch_fused", 1e-4, 1e-3)):
        sr = sessions["summaries"][tag]["sensor_readings"]
        f = direct["force"]
        for k, key in (("force_N", "force_N"), ("volume_cm3", "volume_cm3"),
                       ("contact_area_mm2", "contact_area_mm2"),
                       ("max_depth_mm", "max_depth_mm"), ("scale_mm_per_px", "mm_per_px")):
            assert sr["force"][k] == pytest.approx(f[key], rel=rel, abs=1e-7 if rel else 0.0), \
                (tag, k)
        for k, v in direct["temperature_stats"].items():
            assert sr["temperature"][k] == pytest.approx(v, abs=atol), (tag, k)


@pytest.mark.parametrize("tag", ["torch", "torch_fused"])
def test_session_force_result_and_copies(sessions, tag):
    d, r = sessions["dirs"], sessions["roots"]
    got = rg.load_json(d[tag] / "force_sensing" / "result.json")
    want = rg.load_json(d["jax"] / "force_sensing" / "result.json")
    rg.assert_result_json_within_gates(got, want, r[tag], r["jax"])
    header = rg.read_bytes(d[tag] / "force_sensing" / "result.csv").splitlines()[0]
    assert header == rg.read_bytes(d["jax"] / "force_sensing" / "result.csv").splitlines()[0]
    for name in ("result.json", "result.csv"):
        assert rg.read_bytes(d[tag] / "combined_outputs" / f"force_{name}") == \
            rg.read_bytes(d[tag] / "force_sensing" / name)


@pytest.mark.parametrize("tag", ["torch", "torch_fused"])
def test_session_heightmaps(sessions, tag):
    d = sessions["dirs"]
    ftp = "force_sensing/ftp_run"
    with np.load(d[tag] / ftp / "height_map_bundle.npz") as a, \
            np.load(d["jax"] / ftp / "height_map_bundle.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype, k
            if k.startswith("meta_") or k == "crop_circ_mask":
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    full = np.load(d[tag] / ftp / "height_map_full.npy")
    crop = np.load(d[tag] / ftp / "height_map_crop.npy")
    assert full.shape == (H, W) and full.dtype == np.float32
    np.testing.assert_array_equal(np.isfinite(full).sum(), np.isfinite(crop).sum())
    direct = sessions["direct"]["force"]["height_map_mm_crop"]
    if tag == "torch":
        np.testing.assert_array_equal(crop, direct)
    x1, x2, y1, y2 = sessions["direct"]["force"]["crop_bbox"]
    np.testing.assert_array_equal(full[y1:y2, x1:x2], crop)
    np.testing.assert_array_equal(np.loadtxt(d[tag] / ftp / "height_map_crop.csv",
                                             delimiter=",", dtype=np.float32), crop)


@pytest.mark.parametrize("tag", ["torch", "torch_fused"])
def test_session_masks_and_maps(sessions, tag):
    d = sessions["dirs"]
    temp = "temperature_sensing"
    masks = sorted(n for n in rg.tree(d["jax"] / temp) if n.startswith("mask_"))
    assert len(masks) == 7
    rg.assert_same_pngs(d[tag] / temp, d["jax"] / temp, masks)
    t = sessions["direct"]["temperature"]
    bbox = t["crop_bbox"]
    np.testing.assert_array_equal(rg.png(d[tag] / temp / "mask_dark.png"),
                                  tio.crop2d(t["mask_dark"], bbox).astype(np.uint8) * 255)
    for name in ("temperature_map_final.npy", "temperature_map_fused.npy"):
        a, b = np.load(d[tag] / temp / name), np.load(d["jax"] / temp / name)
        assert a.shape == b.shape == (H, W) and a.dtype == b.dtype == np.float32
        both = np.isfinite(a) & np.isfinite(b)
        assert np.mean(np.isfinite(a) == np.isfinite(b)) >= 1 - rg.VALID_RTOL, name
        assert np.abs(a[both] - b[both]).max() <= rg.T_EXTREME_ATOL, name
    if tag == "torch":
        np.testing.assert_array_equal(np.load(d[tag] / temp / "temperature_map_final.npy"),
                                      t["temperature_map_final"])


def test_session_extract_functions_match_jax():
    calib = {"best_model": {"type": "growth", "equation": "e", "r2": "0.5", "n": 3.0,
                            "n_fit": 2, "n_samples": 9, "rmse": None},
             "x_definition": "x", "volume_definition": "v",
             "models_final": {"global": {"degree": 2.0, "metrics_frames": {"n": 4},
                                         "metrics_means": {"rmse_C": float("inf")}}}}
    for name in ("extract_phase_to_height_metrics", "extract_height_to_force_metrics"):
        for c in (calib, None, {}):
            a, b = getattr(tsession, name)(c), getattr(jsession, name)(c)
            assert json.dumps(a) == json.dumps(b), name
    for c, model in ((calib, "global"), (calib, "heating"), (None, "global")):
        a = tsession.extract_temp_model_metrics(c, model)
        assert json.dumps(a) == json.dumps(jsession.extract_temp_model_metrics(c, model))


# ---------------------------------------------------------------------------
# utils/logging and utils/profiling
# ---------------------------------------------------------------------------

def test_run_logger_and_array_stats_match_jax(tmp_path, capsys):
    rng = np.random.default_rng(4)
    x = rng.normal(size=(32, 48)).astype(np.float32)
    x[0, :5] = np.nan
    mask = rng.random(x.shape) > 0.3
    logs = {}
    for tag, mod in (("jax", jlog), ("torch", tlog)):
        logger = mod.RunLogger(str(tmp_path / tag), debug=True, jsonl=True)
        msgs = [mod.array_stats("x", x, logger=logger),
                mod.array_stats("x", x, mask=mask, logger=logger),
                mod.array_stats("empty", x, mask=np.zeros_like(mask), logger=logger)]
        logger.log("[TEST] plain line")
        logger.event("stage", name="forward", ms=1.5)
        logger.close()
        logs[tag] = msgs
    assert logs["torch"] == logs["jax"]
    assert tlog.array_stats("x", torch.from_numpy(x), torch.from_numpy(mask)) == logs["jax"][1]
    for name in ("debug_log.txt",):
        assert rg.read_bytes(tmp_path / "torch" / name) == rg.read_bytes(tmp_path / "jax" / name)
    ev = [json.loads(line) for line in (tmp_path / "torch" / "events.jsonl").read_text()
          .splitlines()]
    jev = [json.loads(line) for line in (tmp_path / "jax" / "events.jsonl").read_text()
           .splitlines()]
    assert [{k: v for k, v in e.items() if k != "t"} for e in ev] == \
        [{k: v for k, v in e.items() if k != "t"} for e in jev]
    quiet = tlog.RunLogger(str(tmp_path / "quiet"), debug=False)
    quiet.log("nothing")
    assert not (tmp_path / "quiet").exists()
    capsys.readouterr()


def test_array_stats_device_matches_jax():
    import jax.numpy as jnp
    rng = np.random.default_rng(5)
    x = rng.normal(size=(64, 64)).astype(np.float32)
    x[3, 3] = np.inf
    mask = rng.random((64, 64)) > 0.3
    for m in (mask, None):
        got = tlog.array_stats_device(torch.from_numpy(x),
                                      None if m is None else torch.from_numpy(m))
        want = np.asarray(jlog.array_stats_device(jnp.asarray(x),
                                                  None if m is None else jnp.asarray(m)))
        assert got.shape == (9,) and got.dtype == torch.float32 and got.device.type == "cpu"
        # quantiles bit-equal (the same sort and float32 interpolation);
        # mean and std within float32 summation-order rounding
        np.testing.assert_array_equal(got[:7].numpy(), want[:7])
        np.testing.assert_allclose(got[7:].numpy(), want[7:], rtol=1e-5, atol=1e-6)


def test_stage_timer_and_profiling(tmp_path):
    timers = {"jax": jprof.StageTimer(), "torch": tprof.StageTimer("cpu")}
    with timers["torch"].stage("decode"):
        pass
    with timers["torch"].stage("decode"):
        pass
    assert timers["torch"].counts == {"decode": 2}
    for t in timers.values():
        t.totals, t.counts = {"decode": 0.0123, "forward": 0.25}, {"decode": 2, "forward": 1}
    assert timers["torch"].report() == timers["jax"].report()
    assert timers["torch"].report().splitlines()[0].startswith("forward ")
    with tprof.device_trace(str(tmp_path / "trace")):
        torch.ones(8).sum()
    with open(tmp_path / "trace" / "trace.json") as f:
        assert json.load(f)["traceEvents"]
    if torch.cuda.is_available():
        p50, mean, thr = tprof.profile_callable(lambda: torch.ones(8, device="cuda").sum())
        assert p50 > 0 and mean > 0 and thr > 0
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            tprof.profile_callable(lambda: None)
