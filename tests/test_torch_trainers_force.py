"""The port's force trainers (``vistaf_torch/trainers/{phase_to_height,
height_to_force}.py``) against the JAX trainers on the CPU.

Both packages train on the same seeded PNG series at 240x320
(``synthetic_indentation_series``: four p2h indentations and ten loading
frames, one for each of the first ten force levels) under the parity
preset scaled to that size (``scaled_ftp_config(240, 320)``).

- The trainer variant's 80 px ROI erosion and 300 px frontier band are 4K
  pixels; at 240x320 they would empty the 59 px ROI, so both packages'
  ``trainer_ftp_config`` is patched identically to scale them as
  ``scaled_ftp_config`` scales every other pixel length (8 and 29 px), as
  the CLI tests patch ``cli._cfgs``.
- On this synthetic vertical grating the parity ECC's ty is nearly flat
  (``chip_smoke.py``'s ``ALIGNMENT_UNDETERMINED``): free-running, the port's
  and JAX's solves end up to 0.05 px apart and the minima 0.6% apart.  So
  the JAX trainers run with debug outputs (one compile each, two in all)
  and record each frame's global shift and ECC warp, and the port's
  trainers are held to them given that alignment (``phase_correlate`` and
  ``FTPPipeline._ecc`` return JAX's), as ``chip_smoke.same_alignment``
  holds the card to the CPU: ``min_height_unitless`` within 1e-4 relative
  at the same pixel (or JAX's map at the port's pixel within that), the
  volumes within 2e-5 relative (1e-9 cm^3 absolute near zero), the
  period within 1e-6.  The volumes' gap is the FFTs' rounding (pocketfft
  against XLA's), which moves the heightmap by ~1e-7: 1.4e-5 on the
  shallowest dent, whose volume is the smallest sum over the 0.01 mm
  threshold, and 4e-6 or less on the others.  The free-running port run
  is held to the force contract's 1%.
- The fitting is a copy, so both packages' ``fit_best_model`` on the same
  (x, y) are bit-equal; the trainers' models are compared by type and by
  RMSE within 1e-3 relative, not by their parameters (n=4 fits are
  degenerate in parameter space, ``tests/test_trainers.py``).
- A second port h2f run over the same output resumes by skipping every
  frame and leaves the files as they were.
"""
import csv
import dataclasses
import json
import os

import cv2
import numpy as np
import pytest
import torch

from vistaf_tpu.calib import fitting as jfitting
from vistaf_tpu.trainers import height_to_force as jh2f
from vistaf_tpu.trainers import phase_to_height as jp2h
from vistaf_tpu.utils.synthetic import scaled_ftp_config

import vistaf_torch.ftp.pipeline as tpipe
from vistaf_torch.calib import fitting
from vistaf_torch.config import ftp_config_from_dict
from vistaf_torch.trainers import height_to_force as th2f
from vistaf_torch.trainers import phase_to_height as tp2h
from vistaf_torch.utils.synthetic import synthetic_indentation_series
import chip_smoke
from torch_threads import single_torch_thread  # noqa: F401  (autouse)

H, W = 240, 320
P2H_DENTS = (0.5, 0.7, 0.9, 1.1)
H2F_DENTS = tuple(0.1 + 0.1 * i for i in range(10))
MIN_RTOL, VOLUME_RTOL, VOLUME_ATOL, PERIOD_RTOL = 1e-4, 2e-5, 1e-9, 1e-6
RMSE_RTOL, FREE_RTOL = 1e-3, 0.01
P2H_FILES = {"calibration_model.json", "calibration_results.csv", "calibration_plot.png"}
H2F_FILES = {"calibration_model.json", "per_image_results.csv", "per_image_results.jsonl",
             "volume_by_force_boxplot.png", "force_vs_volume_fit.png"}


def _scaled_trainer_cfg(original):
    s = np.sqrt(H / 2160 * W / 3840)

    def cfg(base=None):
        return original(base).replace(roi_erode_px=int(round(80 * s)),
                                      frontier_zero_band_px=int(round(300 * s)))
    return cfg


def _recorder(base, frames):
    """The JAX FTPPipeline with debug outputs, recording each frame's result."""
    class Recorder(base):
        def __init__(self, cfg, p2h, use_neg):
            super().__init__(cfg, p2h, use_neg, debug_outputs=True)

        def __call__(self, ref, de):
            res = super().__call__(ref, de)
            frames.append(res)
            return res
    return Recorder


def install_alignment(mp, frames):
    """Make the port's FTP forwards take JAX's recorded alignment, frame by
    frame: the global shift from ``phase_correlate``, the ECC warp from
    ``FTPPipeline._ecc`` (as ``chip_smoke.same_alignment`` does)."""
    it = iter(frames)
    current = {}

    def phase_correlate(a, b, win):
        current["res"] = res = next(it)
        dx, dy = (torch.as_tensor(v) for v in res["dbg_global_shift"])
        return dx, dy, torch.zeros(())

    def ecc(self, crop01):
        return tuple(torch.as_tensor(np.array(current["res"][k]))
                     for k in ("dbg_ecc_warp", "dbg_ecc_rho", "dbg_ecc_iters"))
    mp.setattr(tpipe, "phase_correlate", phase_correlate)
    mp.setattr(tpipe.FTPPipeline, "_ecc", ecc)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("force_trainers")
    data = str(root / "data")
    os.makedirs(data)
    jcfg = scaled_ftp_config(H, W)
    tcfg = ftp_config_from_dict(dataclasses.asdict(jcfg))
    ref, defs = synthetic_indentation_series(H, W, tcfg, P2H_DENTS + H2F_DENTS, seed=0)
    ref_p = os.path.join(data, "ref.png")
    assert cv2.imwrite(ref_p, ref)
    samples = []
    for (name, depth), im in zip(jp2h.DEFAULT_CALIBRATION_SAMPLES, defs[:4]):
        samples.append((name.replace(".jpg", ".png"), depth))
        assert cv2.imwrite(os.path.join(data, samples[-1][0]), im)
    for i, im in enumerate(defs[4:]):
        assert cv2.imwrite(os.path.join(data, f"sphere-{1 + 5 * i}.png"), im)
    out = {k: str(root / k) for k in ("jp2h", "tp2h", "jh2f", "th2f", "th2f_free")}
    jframes = {"p2h": [], "h2f": []}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jp2h, "trainer_ftp_config", _scaled_trainer_cfg(jp2h.trainer_ftp_config))
        mp.setattr(tp2h, "trainer_ftp_config", _scaled_trainer_cfg(tp2h.trainer_ftp_config))
        mp.setattr(jp2h, "FTPPipeline", _recorder(jp2h.FTPPipeline, jframes["p2h"]))
        mp.setattr(jh2f, "FTPPipeline", _recorder(jh2f.FTPPipeline, jframes["h2f"]))
        jm = jp2h.train(ref_p, samples, data, out["jp2h"], ftp_cfg=jcfg)
        p2h = jm["best_model"]
        jf = jh2f.train(ref_p, data, out["jh2f"], p2h, True, ftp_cfg=jcfg,
                        image_pattern="sphere-{}.png")
        free = th2f.train(ref_p, data, out["th2f_free"], p2h, True, ftp_cfg=tcfg,
                          image_pattern="sphere-{}.png", device="cpu")
        install_alignment(mp, jframes["p2h"])
        tm = tp2h.train(ref_p, samples, data, out["tp2h"], ftp_cfg=tcfg, device="cpu")
        install_alignment(mp, jframes["h2f"])
        tf = th2f.train(ref_p, data, out["th2f"], p2h, True, ftp_cfg=tcfg,
                        image_pattern="sphere-{}.png", device="cpu")
    return {"out": out, "jframes": jframes, "models": (jm, tm, jf, tf, free), "jcfg": jcfg,
            "tcfg": tcfg, "ref": ref_p, "data": data, "p2h": p2h, "samples": samples}


def _rows(path):
    with open(path, newline="", encoding="utf-8") as f:
        return list(csv.DictReader(f))


def _rel(a, b):
    return abs(a - b) / abs(b)


def test_trainer_config_is_the_jax_variant():
    from vistaf_tpu.config import FTPConfig as JaxFTPConfig
    from vistaf_torch.config import FTPConfig
    assert dataclasses.asdict(tp2h.trainer_ftp_config()) == \
        dataclasses.asdict(jp2h.trainer_ftp_config())
    assert tp2h.trainer_ftp_config(FTPConfig().deploy()) == ftp_config_from_dict(
        dataclasses.asdict(jp2h.trainer_ftp_config(JaxFTPConfig().deploy())))
    assert tp2h.DEFAULT_CALIBRATION_SAMPLES == jp2h.DEFAULT_CALIBRATION_SAMPLES
    assert tp2h.MODEL_CANDIDATES == jp2h.MODEL_CANDIDATES
    assert (th2f.FORCE_LEVELS_N, th2f.IMAGES_PER_LEVEL, th2f.MODEL_CANDIDATES,
            th2f.CSV_FIELDS) == (jh2f.FORCE_LEVELS_N, jh2f.IMAGES_PER_LEVEL,
                                 jh2f.MODEL_CANDIDATES, jh2f.CSV_FIELDS)


def test_compute_min_height_takes_numpy_first_minimum():
    """The device reduction against the JAX host one, ties and NaNs
    included: the first minimum in row-major order."""
    rng = np.random.default_rng(3)
    h = rng.integers(-3, 3, size=(17, 23)).astype(np.float32)
    h[rng.random(h.shape) < 0.1] = np.nan
    m = rng.random(h.shape) < 0.7
    assert tp2h.compute_min_height(torch.as_tensor(h), torch.as_tensor(m)) == \
        jp2h.compute_min_height(h, m)
    none = np.zeros_like(m)
    got = tp2h.compute_min_height(torch.as_tensor(h), torch.as_tensor(none))
    assert np.isnan(got[0]) and got[1] is None and jp2h.compute_min_height(h, none)[1] is None


def test_p2h_rows_match_jax_given_its_alignment(runs):
    out = runs["out"]
    jr, tr = (_rows(os.path.join(out[k], "calibration_results.csv")) for k in ("jp2h", "tp2h"))
    assert len(jr) == len(tr) == 4
    for j, t, res in zip(jr, tr, runs["jframes"]["p2h"]):
        assert (t["file"], t["depth_mm"]) == (j["file"], j["depth_mm"])
        mj, mt = float(j["min_height_unitless"]), float(t["min_height_unitless"])
        assert mj < 0 and _rel(mt, mj) <= MIN_RTOL, (t["file"], mt, mj)
        if (t["min_x"], t["min_y"]) != (j["min_x"], j["min_y"]):
            at = res["height_map_unitless_crop"][int(t["min_y"]), int(t["min_x"])]
            assert _rel(float(at), mj) <= MIN_RTOL, (t["file"], at, mj)


def test_p2h_fit_is_the_jax_fit(runs):
    jm, tm = runs["models"][:2]
    for k in ("use_negated_height_for_fit", "x_definition", "interpretation"):
        assert tm[k] == jm[k]
    assert list(tm["best_model"]) == list(jm["best_model"])
    assert tm["best_model"]["type"] == jm["best_model"]["type"]
    assert tm["best_model"]["n"] == jm["best_model"]["n"] == 4
    assert _rel(tm["best_model"]["rmse"], jm["best_model"]["rmse"]) <= RMSE_RTOL
    # the fitting is a copy: the same (x, y) give the same bits
    rows = _rows(os.path.join(runs["out"]["tp2h"], "calibration_results.csv"))
    x = np.maximum(-np.array([float(r["min_height_unitless"]) for r in rows]), 0.0)
    y = np.array([float(r["depth_mm"]) for r in rows])
    np.testing.assert_equal(fitting.fit_best_model(x, y, tp2h.MODEL_CANDIDATES),
                            jfitting.fit_best_model(x, y, jp2h.MODEL_CANDIDATES))
    with open(os.path.join(runs["out"]["tp2h"], "calibration_model.json")) as f:
        assert json.load(f)["best_model"] == tm["best_model"]


def _assert_h2f_row(t, j):
    assert list(t) == list(j) == th2f.CSV_FIELDS
    assert (t["file"], float(t["force_N"])) == (j["file"], float(j["force_N"]))
    vt, vj = float(t["volume_cm3"]), float(j["volume_cm3"])
    assert abs(vt - vj) <= max(VOLUME_RTOL * abs(vj), VOLUME_ATOL), (t["file"], vt, vj)
    for k in ("contact_area_mm2", "max_depth_mm"):
        a, b = float(t[k]), float(j[k])
        assert abs(a - b) <= max(VOLUME_RTOL * abs(b), VOLUME_ATOL), (t["file"], k, a, b)
    for k in ("mm_per_px", "estimated_grating_period_px"):
        assert _rel(float(t[k]), float(j[k])) <= PERIOD_RTOL, (t["file"], k)


def test_h2f_rows_match_jax_given_its_alignment(runs):
    out = runs["out"]
    jr, tr = (_rows(os.path.join(out[k], "per_image_results.csv")) for k in ("jh2f", "th2f"))
    assert [r["file"] for r in jr] == [f"sphere-{1 + 5 * i}.png" for i in range(10)]
    assert [float(r["force_N"]) for r in jr] == list(jh2f.FORCE_LEVELS_N[:10])
    assert len(tr) == len(jr)
    for t, j in zip(tr, jr):
        _assert_h2f_row(t, j)
    jl, tl = ([json.loads(line) for line in open(os.path.join(out[k], "per_image_results.jsonl"))]
              for k in ("jh2f", "th2f"))
    assert len(tl) == len(jl) == 10
    for t, j in zip(tl, jl):
        assert t["ftp_output_dir"] == out["th2f"] and j["ftp_output_dir"] == out["jh2f"]
        _assert_h2f_row({k: str(v) for k, v in t.items()}, {k: str(v) for k, v in j.items()})
    # the volumes rise with the dent, so the fit sees a loading curve
    v = [float(r["volume_cm3"]) for r in tr]
    assert v[-1] > v[0] > 0


def test_h2f_model_matches_jax(runs):
    _, _, jf, tf, free = runs["models"]
    for m in (tf, free):
        assert list(m) == list(jf) and list(m["best_model"]) == list(jf["best_model"])
        assert m["best_model"]["type"] == jf["best_model"]["type"]
        assert (m["best_model"]["n_fit"], m["best_model"]["n_samples"]) == (30, 10)
    assert _rel(tf["best_model"]["rmse"], jf["best_model"]["rmse"]) <= RMSE_RTOL
    for k in ("volume_definition", "grating_pitch_mm", "depth_eps_mm", "anchor_origin",
              "origin_weight"):
        assert tf[k] == jf[k]


def test_h2f_free_running_within_the_force_contract(runs):
    out = runs["out"]
    jr, fr = (_rows(os.path.join(out[k], "per_image_results.csv"))
              for k in ("jh2f", "th2f_free"))
    for f, j in zip(fr, jr):
        assert _rel(float(f["volume_cm3"]), float(j["volume_cm3"])) <= FREE_RTOL, f["file"]


def test_output_file_sets_are_the_jax_trainers(runs):
    out = runs["out"]
    for a, b, want in (("tp2h", "jp2h", P2H_FILES), ("th2f", "jh2f", H2F_FILES)):
        assert set(os.listdir(out[a])) == set(os.listdir(out[b])) == want
        assert all(os.path.getsize(os.path.join(out[a], n)) > 0 for n in want)
    # the sets chip_smoke.py holds the card's runs to
    assert (set(chip_smoke.P2H_FILES), set(chip_smoke.H2F_FILES)) == (P2H_FILES, H2F_FILES)


def test_a_jax_written_model_drives_the_port_force_pipeline(runs, tmp_path):
    """The JAX trainers' calibration_model.json files, laid out as the
    reference's, load through the port's ``ForcePipeline.from_artifacts``:
    on a loading frame its volume is the port's free-running h2f row, bit
    for bit, and its force the JAX h2f model's prediction of that volume."""
    import shutil
    from vistaf_tpu.calib.scalar_models import predict_force_from_volume as jforce
    from vistaf_torch.config import HEIGHT_TO_FORCE_JSON, PHASE_TO_HEIGHT_JSON
    from vistaf_torch.pipelines.force import ForcePipeline
    for src, dst in (("jp2h", PHASE_TO_HEIGHT_JSON), ("jh2f", HEIGHT_TO_FORCE_JSON)):
        os.makedirs(os.path.dirname(str(tmp_path / dst)), exist_ok=True)
        shutil.copy(os.path.join(runs["out"][src], "calibration_model.json"), tmp_path / dst)
    pipe = ForcePipeline.from_artifacts(str(tmp_path), ftp_cfg=runs["tcfg"], device="cpu")
    assert pipe.ftp.p2h_model == runs["p2h"] == runs["models"][0]["best_model"]
    assert pipe.force_model == runs["models"][2]["best_model"]
    (row,) = [r for r in _rows(os.path.join(runs["out"]["th2f_free"], "per_image_results.csv"))
              if r["file"] == "sphere-46.png"]
    ref, de = (cv2.imread(os.path.join(runs["data"], n)) for n in ("ref.png", "sphere-46.png"))
    res = pipe(ref, de)
    assert res["volume_cm3"] == float(row["volume_cm3"])
    want = float(jforce(runs["models"][2]["best_model"], res["volume_cm3"],
                          xp=np))
    assert abs(res["force_N"] - want) <= 1e-12 * abs(want)


def test_h2f_resume_skips_every_frame_and_keeps_the_files(runs, monkeypatch):
    out = runs["out"]["th2f"]
    before = {n: open(os.path.join(out, n), "rb").read()
              for n in ("per_image_results.csv", "per_image_results.jsonl",
                        "calibration_model.json")}
    install_alignment(monkeypatch, [])   # a frame processed now raises StopIteration
    again = th2f.train(runs["ref"], runs["data"], out, runs["p2h"], True,
                       ftp_cfg=runs["tcfg"], image_pattern="sphere-{}.png", device="cpu")
    after = {n: open(os.path.join(out, n), "rb").read() for n in before}
    assert after == before
    assert again["best_model"]["n_samples"] == 10


def test_trainers_on_cuda_without_a_card_raise(tmp_path, runs):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises((RuntimeError, AssertionError)):
        th2f.train(runs["ref"], runs["data"], str(tmp_path), runs["p2h"], True,
                   ftp_cfg=runs["tcfg"], image_pattern="sphere-{}.png")
