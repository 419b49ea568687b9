"""The port's temperature trainers and pretest (``vistaf_torch/trainers/
{temperature_color,temperature_black,pretest}.py``) against the JAX ones on
the CPU, at 64x64 as ``tests/test_trainer_plots.py`` runs them (its small
annulus, 7 temperatures x 2 frames a run, degrees (1, 2), 64 pixels an
image for the black trainer), on one seeded JPEG series of
``synthetic_tlc_series`` (heating, and the same temperatures reversed for
cooling) that both packages read.

- The chosen degrees are equal, ``models_final_summary_metrics.json``
  agrees within 1e-6 (its ``output_dir`` aside) and the file sets are equal,
  figures and joblib bundles included (matplotlib, sklearn and joblib are
  here).
- The ``.npz`` weights agree within 1e-7 relative.  The polynomial's bias
  column duplicates the intercept's, so the Huber fit determines only
  their sum (``calib/huber.py``); the split between them is set by the
  solve's rounding in both packages.  So the sum ``coef[0] + intercept``
  and every other coefficient are held to 1e-7 relative (of the largest
  coefficient's magnitude), and the split itself to 1e-4 absolute.
- The equations text has the same lines; its numbers (8 significant
  digits) are held as the weights are.
- Pretest: ``mean_L`` within 1e-3 and the same stabilization index.  The
  port's unfused LAB is one 8-bit step off JAX's on 163 of 2^24 BGR
  values (XLA's CPU FMAs, ROADMAP Queue 3 item 3), which the tolerance
  covers; the masked mean itself is exact (``masked_means_f32``).
- Weights across, both ways: a JAX-written ``.npz`` loads through the
  port's ``TempModelWeights.load_npz`` and a port-written one through
  JAX's, and the two ``predict`` agree within 1e-5 degC.  Both evaluate in
  float32, whose spacing is 1.9e-6 degC between 16 and 32 degC, and XLA's
  CPU code contracts the polynomial's multiply-adds into FMAs where the
  port rounds each (ROADMAP Queue 3 item 3): up to three spacings apart
  (5.7e-6 degC) on these models.
"""
import json
import os
import re

import cv2
import numpy as np
import pytest
import torch

from vistaf_tpu.calib.temp_weights import TempModelWeights as JaxWeights
from vistaf_tpu.trainers import pretest as jpretest
from vistaf_tpu.trainers import temperature_black as jblack
from vistaf_tpu.trainers import temperature_color as jcolor

from vistaf_torch.calib.temp_weights import TempModelWeights
from vistaf_torch.trainers import pretest, temperature_black, temperature_color
from vistaf_torch.trainers import temperature_common as tc
from vistaf_torch.utils.synthetic import synthetic_tlc_series
import chip_smoke
from test_trainer_plots import BLACK_FIG_SET, COLOR_FIG_SET, INNER, OUTER
from torch_threads import single_torch_thread  # noqa: F401  (autouse)

TEMPS = list(range(20, 27))
FRAMES = 2
METRIC_ATOL, COEF_RTOL, SPLIT_ATOL, MEAN_L_ATOL, PREDICT_ATOL = 1e-6, 1e-7, 1e-4, 1e-3, 1e-5
PRETEST_LEVELS = [20.0 + 6.0 * (1.0 - np.exp(-i / 4.0)) for i in range(24)]


def write_series(dirpath, stem, temps, frames, seed, t_span=None, jitter=1.0):
    """One JPEG a frame, ``{stem}-{i}.jpg`` from 1, as the trainers glob."""
    os.makedirs(dirpath, exist_ok=True)
    per = [t for t in temps for _ in range(frames)]
    for i, img in enumerate(synthetic_tlc_series(64, 64, per, t_span=t_span, jitter=jitter,
                                                 seed=seed), 1):
        assert cv2.imwrite(os.path.join(dirpath, f"{stem}-{i}.jpg"), img)


def trained_files(out):
    return {n for n in os.listdir(out) if os.path.getsize(os.path.join(out, n)) > 0}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("temp_trainers")
    heat, cool, series = (str(root / k) for k in ("heat", "cool", "series"))
    write_series(heat, "heating", TEMPS, FRAMES, seed=1)
    write_series(cool, "cooling", TEMPS[::-1], FRAMES, seed=2, t_span=(TEMPS[0], TEMPS[-1]))
    write_series(series, "img", PRETEST_LEVELS, 1, seed=3, jitter=0.0)
    out = {}
    for tag, mod, kw in (("jcolor", jcolor, {}), ("tcolor", temperature_color, {"device": "cpu"})):
        out[tag] = str(root / tag)
        mod.train(os.path.join(heat, "heating-*.jpg"), os.path.join(cool, "cooling-*.jpg"),
                  out[tag], temps_heating=TEMPS, frames_per_temp=FRAMES,
                  fit_temp_range=(TEMPS[0], TEMPS[-1]), degree_candidates=(1, 2),
                  inner_circle=INNER, outer_circle=OUTER, **kw)
    for tag, mod, kw in (("jblack", jblack, {}), ("tblack", temperature_black, {"device": "cpu"})):
        out[tag] = str(root / tag)
        mod.train(os.path.join(heat, "heating-*.jpg"), os.path.join(cool, "cooling-*.jpg"),
                  out[tag], temps_heating=TEMPS, frames_per_temp=FRAMES,
                  degree_candidates=(1, 2), pixels_per_image=64,
                  inner_circle=INNER, outer_circle=OUTER, **kw)
    mask = np.ones((64, 64), bool)
    mask[:6] = False
    pre = {}
    for tag, mod, kw in (("jpre", jpretest, {}), ("tpre", pretest, {"device": "cpu"})):
        out[tag] = str(root / tag)
        pre[tag] = mod.analyze(os.path.join(series, "img-*.jpg"), mask, dt_s=20.0,
                               out_dir=out[tag], label="25to30", **kw)
    return {"out": out, "pre": pre, "heat": heat, "cool": cool}


def _summary(out):
    with open(os.path.join(out, "models_final_summary_metrics.json")) as f:
        doc = json.load(f)
    assert doc.pop("output_dir") == os.path.abspath(out)
    return doc


def _assert_numbers_close(a, b, atol, where=""):
    if isinstance(b, dict):
        assert list(a) == list(b), where
        for k in b:
            _assert_numbers_close(a[k], b[k], atol, f"{where}.{k}")
    elif isinstance(b, list):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_numbers_close(x, y, atol, f"{where}[{i}]")
    elif isinstance(b, float) and not isinstance(b, bool):
        assert isinstance(a, float) and abs(a - b) <= atol, (where, a, b)
    elif isinstance(b, str) and b.startswith("T ="):
        _assert_equation_close(a, b)
    else:
        assert a == b, (where, a, b)


_NUM = re.compile(r"[-+]?\d+\.?\d*(?:e[-+]?\d+)?")


def _assert_equation_close(a: str, b: str):
    """Same terms; the numbers as the weights are held (``_assert_weights``),
    the first (the intercept) and the bias term's together."""
    na, nb = (np.array([float(x) for x in _NUM.findall(re.sub(r"\^\d+", "", s))])
              for s in (a, b))
    assert _NUM.sub("#", a) == _NUM.sub("#", b)
    assert na.shape == nb.shape
    np.testing.assert_allclose(na, nb, rtol=0, atol=SPLIT_ATOL)
    # 8 significant digits: each printed number within half a unit of its last
    # digit of the weight, which agree to COEF_RTOL of the largest
    tol = COEF_RTOL * np.abs(nb).max() + 1e-8 * np.abs(nb[2:])
    assert (np.abs(na[2:] - nb[2:]) <= tol).all(), (na, nb)


def _assert_weights(t: TempModelWeights, j: JaxWeights):
    assert (t.name, t.feature_names, t.poly_degree) == (j.name, j.feature_names, j.poly_degree)
    np.testing.assert_array_equal(t.powers, j.powers)
    np.testing.assert_allclose(t.scaler_mean, j.scaler_mean, rtol=COEF_RTOL)
    np.testing.assert_allclose(t.scaler_scale, j.scaler_scale, rtol=COEF_RTOL)
    scale = np.abs(j.coef).max()
    np.testing.assert_allclose(t.coef[1:], j.coef[1:], rtol=0, atol=COEF_RTOL * scale)
    assert abs((t.coef[0] + t.intercept) - (j.coef[0] + j.intercept)) <= \
        COEF_RTOL * abs(j.coef[0] + j.intercept)
    assert abs(t.intercept - j.intercept) <= SPLIT_ATOL
    for a, b in ((t.iso_x, j.iso_x), (t.iso_y, j.iso_y)):
        assert (a is None) == (b is None)
        if b is not None:
            np.testing.assert_allclose(a, b, rtol=COEF_RTOL, atol=1e-9)


@pytest.mark.parametrize("kind", ["color", "black"])
def test_trainer_matches_jax(runs, kind):
    j, t = runs["out"][f"j{kind}"], runs["out"][f"t{kind}"]
    sj, st = _summary(j), _summary(t)
    assert [st["models_final"][k]["degree"] for k in ("heating", "cooling", "global")] == \
        [sj["models_final"][k]["degree"] for k in ("heating", "cooling", "global")]
    _assert_numbers_close(st, sj, METRIC_ATOL)
    npz = sorted(n for n in os.listdir(j) if n.endswith(".npz"))
    assert len(npz) == 3
    for name in npz:
        _assert_weights(TempModelWeights.load_npz(os.path.join(t, name)),
                        JaxWeights.load_npz(os.path.join(j, name)))
    eq = f"equations_{kind}_models_final.txt"
    lt, lj = (open(os.path.join(r, eq)).read().split("\n\n") for r in (t, j))
    assert len(lt) == len(lj) == 3
    for a, b in zip(lt, lj):
        ha, ea = a.split("\nT =", 1)
        hb, eb = b.split("\nT =", 1)
        assert ha == hb
        _assert_equation_close("T =" + ea, "T =" + eb)


@pytest.mark.parametrize("kind", ["color", "black"])
def test_trainer_file_set_is_the_jax_trainers(runs, kind):
    j, t = runs["out"][f"j{kind}"], runs["out"][f"t{kind}"]
    files = trained_files(t)
    assert files == trained_files(j)
    assert set(COLOR_FIG_SET if kind == "color" else BLACK_FIG_SET) <= files
    # the set chip_smoke.py holds the card's run to
    assert files == chip_smoke.temperature_trainer_files(kind, _summary(t), joblib_too=True)
    assert sum(n.endswith(".joblib") for n in files) == 3
    assert sum(n.endswith(".npz") for n in files) == 3
    if kind == "color":
        with open(os.path.join(t, "07_global_per_temp_error.csv")) as f, \
                open(os.path.join(j, "07_global_per_temp_error.csv")) as g:
            a, b = f.read().splitlines(), g.read().splitlines()
        assert a[0] == b[0] and len(a) == len(b) == 1 + len(TEMPS)
        assert [r.split(",")[0] for r in a[1:]] == ["global"] * len(TEMPS)
        np.testing.assert_allclose(np.array([r.split(",")[1:] for r in a[1:]], float),
                                   np.array([r.split(",")[1:] for r in b[1:]], float),
                                   rtol=0, atol=METRIC_ATOL)


def test_pretest_matches_jax(runs):
    j, t = runs["pre"]["jpre"], runs["pre"]["tpre"]
    assert t["n_frames"] == j["n_frames"] == len(PRETEST_LEVELS)
    np.testing.assert_allclose(t["mean_L"], j["mean_L"], rtol=0, atol=MEAN_L_ATOL)
    assert t["stabilization"] is not None
    assert t["stabilization"]["index"] == j["stabilization"]["index"]
    assert t["stabilization"]["time_s"] == j["stabilization"]["time_s"]
    for k in ("final_mean_L", "tolerance", "total_change"):
        assert abs(t["stabilization"][k] - j["stabilization"][k]) <= MEAN_L_ATOL
    assert os.path.basename(t["figure_path"]) == "Figure_1_pretest_25to30.png"
    assert trained_files(runs["out"]["tpre"]) == trained_files(runs["out"]["jpre"])


def test_stabilization_detector_is_the_jax_one():
    v = np.concatenate([np.linspace(100, 140, 20), np.full(12, 140.0)])
    v += np.random.default_rng(0).normal(scale=0.2, size=len(v))
    for window, tol in ((5, 1.0), (3, 0.1), (40, 1.0)):
        assert pretest.detect_stabilization_time(v, 20.0, window, tol_abs=tol) == \
            jpretest.detect_stabilization_time(v, 20.0, window, tol_abs=tol)


def test_feature_means_and_pixel_samples_match_jax(runs):
    """The masked means (exact sums, one float32 rounding) and the drawn
    pixel samples bit-equal to the JAX trainers' on the same files."""
    from vistaf_tpu.trainers import temperature_common as jtc
    files = tc.load_images_sorted(os.path.join(runs["heat"], "heating-*.jpg"))
    assert files == jtc.load_images_sorted(os.path.join(runs["heat"], "heating-*.jpg"))
    mask = tc.annulus_roi(64, 64, INNER, OUTER)
    np.testing.assert_array_equal(mask, jtc.annulus_roi(64, 64, INNER, OUTER))
    np.testing.assert_array_equal(tc.mean_features_for_sequence(files, mask, True, device="cpu"),
                                  jtc.mean_features_for_sequence(files, mask, True))
    y = np.repeat(np.asarray(TEMPS, float), FRAMES)
    for ppi, cap in ((64, 10**6), (50, 120)):
        got = tc.pixel_samples_for_sequence(files, mask, y, ppi, cap, seed=5, device="cpu")
        want = jtc.pixel_samples_for_sequence(files, mask, y, ppi, cap, seed=5)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_weights_load_across_both_ways(runs, direction, tmp_path):
    src = runs["out"]["jcolor" if direction == "jax_to_port" else "tcolor"]
    rng = np.random.default_rng(7)
    for name in sorted(n for n in os.listdir(src) if n.endswith(".npz")):
        path = os.path.join(src, name)
        t, j = TempModelWeights.load_npz(path), JaxWeights.load_npz(path)
        X = rng.uniform([60, 110, 110], [200, 160, 160], size=(512, 3)).astype(np.float32)
        pt = t.predict(torch.as_tensor(X)).numpy()
        pj = np.asarray(j.predict(X))
        assert np.isfinite(pt).all()
        np.testing.assert_allclose(pt, pj, rtol=0, atol=PREDICT_ATOL)
    # and the black models, over (L, a, b, gray)
    src = runs["out"]["jblack" if direction == "jax_to_port" else "tblack"]
    for name in sorted(n for n in os.listdir(src) if n.endswith(".npz")):
        path = os.path.join(src, name)
        t, j = TempModelWeights.load_npz(path), JaxWeights.load_npz(path)
        X = rng.uniform([40, 110, 110, 40], [200, 160, 160, 200], size=(512, 4)).astype(np.float32)
        np.testing.assert_allclose(t.predict(torch.as_tensor(X)).numpy(),
                                   np.asarray(j.predict(X)), rtol=0, atol=PREDICT_ATOL)


def test_joblib_export_without_sklearn_writes_nothing(tmp_path, monkeypatch):
    """Where joblib or sklearn is missing the bundle is skipped, as JAX's."""
    import builtins
    real = builtins.__import__

    def no_sklearn(name, *a, **k):
        if name.split(".")[0] in ("joblib", "sklearn"):
            raise ImportError(name)
        return real(name, *a, **k)
    from vistaf_torch.utils.synthetic import synthetic_temp_weights
    monkeypatch.setattr(builtins, "__import__", no_sklearn)
    tc.export_joblib_bundle(str(tmp_path / "m.joblib"), synthetic_temp_weights()[0], None)
    assert not os.listdir(tmp_path)


def test_figure_recorders_stand_for_the_figures(runs, tmp_path):
    """Where matplotlib is missing chip_smoke.py swaps the trainers' figure
    writers for recorders: every writer that draws is swapped, and the
    recorded paths with the files written are the set a run with
    matplotlib writes."""
    from vistaf_torch.trainers import plots
    import inspect
    drawing = {n for n, f in vars(plots).items() if inspect.isfunction(f)
               and f.__module__ == plots.__name__ and n != "_plt"
               and "_plt()" in inspect.getsource(f)}
    assert drawing == set(chip_smoke.FIGURE_WRITERS)
    out, sink = str(tmp_path / "color"), []
    with chip_smoke.figure_recorders(True, sink):
        temperature_color.train(os.path.join(runs["heat"], "heating-*.jpg"),
                                os.path.join(runs["cool"], "cooling-*.jpg"), out,
                                temps_heating=TEMPS, frames_per_temp=FRAMES,
                                fit_temp_range=(TEMPS[0], TEMPS[-1]), degree_candidates=(1, 2),
                                inner_circle=INNER, outer_circle=OUTER, device="cpu")
    assert all(getattr(plots, n).__module__ == plots.__name__ for n in chip_smoke.FIGURE_WRITERS)
    assert not any(n.endswith(".png") for n in os.listdir(out))
    assert chip_smoke.trained_tree(out, sink) == trained_files(runs["out"]["tcolor"])
