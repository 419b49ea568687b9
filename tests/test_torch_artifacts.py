"""The loaders from artifacts: ``calib/artifacts.py``, the joblib model
bundles (``calib/temp_weights.py``: ``from_joblib``, ``resolve_latest``,
``load_reference_models``) and ``from_artifacts`` of the force,
temperature and multimodal pipelines, in the port against the JAX package,
on a data root in the reference layout written here: the two force
calibration JSONs, and temperature bundles written by the JAX trainer's own
``export_joblib_bundle`` (sklearn pipelines pickled by joblib) from the
deploy weights' form.

Gates: both packages load the same weights and calibrations, bit for bit;
the pipelines ``from_artifacts`` builds give the same output, bit for bit,
as pipelines built by their constructors from those weights (on the CPU,
at small parity sizes); missing or corrupt artifacts raise what the JAX
package raises.
"""
import dataclasses
import json
import os

import numpy as np
import pytest

from vistaf_tpu.calib import artifacts as jart
from vistaf_tpu.calib import temp_weights as jtw
from vistaf_tpu.config import ForceConfig as JaxForceConfig
from vistaf_tpu.pipelines.force import ForcePipeline as JaxForcePipeline
from vistaf_tpu.trainers.temperature_common import export_joblib_bundle
from vistaf_tpu.utils.synthetic import scaled_ftp_config, scaled_temp_config

from vistaf_torch import config as tconfig
from vistaf_torch.calib import artifacts, temp_weights
from vistaf_torch.config import (force_config_from_dict, ftp_config_from_dict,
                                 temp_config_from_dict)
from vistaf_torch.pipelines.force import ForcePipeline
from vistaf_torch.pipelines.multimodal import MultimodalPipeline
from vistaf_torch.temperature.inference import TemperaturePipeline
from vistaf_torch.utils.synthetic import (synthetic_deploy_temp_weights, synthetic_pair,
                                          synthetic_tlc_frame)

import torch_slice_gates as gates
from torch_threads import single_torch_thread  # noqa: F401  (autouse)

FIELDS = [f.name for f in dataclasses.fields(temp_weights.TempModelWeights)]


def _write_root(root):
    """The reference layout under ``root``: force JSONs and one COLOR and
    one WIDE bundle (degree 2 and 3)."""
    artifacts.save_json(os.path.join(root, tconfig.PHASE_TO_HEIGHT_JSON),
                        {"best_model": gates.P2H, "use_negated_height_for_fit": True})
    artifacts.save_json(os.path.join(root, tconfig.HEIGHT_TO_FORCE_JSON),
                        {"best_model": gates.FORCE, "rmse": 0.1})
    color, wide = (jtw.TempModelWeights(**dataclasses.asdict(m))
                   for m in synthetic_deploy_temp_weights(seed=0))
    cdir = os.path.dirname(os.path.join(root, tconfig.TEMP_COLOR_MODEL_GLOB))
    wdir = os.path.dirname(os.path.join(root, tconfig.TEMP_WIDE_MODEL_GLOB))
    export_joblib_bundle(os.path.join(cdir, "color_model_global_huber_deg2.joblib"), color,
                         (20.0, 33.0))
    export_joblib_bundle(os.path.join(wdir, "black_model_global_huber_deg3.joblib"), wide,
                         (20.0, 75.0))


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    r = str(tmp_path_factory.mktemp("data_root"))
    _write_root(r)
    return r


def test_artifact_paths_match_jax():
    from vistaf_tpu import config as jconfig
    for name in ("PHASE_TO_HEIGHT_JSON", "HEIGHT_TO_FORCE_JSON", "TEMP_COLOR_METRICS_JSON",
                 "TEMP_BLACK_METRICS_JSON", "TEMP_COLOR_MODEL_GLOB", "TEMP_WIDE_MODEL_GLOB"):
        assert getattr(tconfig, name) == getattr(jconfig, name), name


def test_reference_models_load_the_same_weights(root):
    tc, tw = temp_weights.load_reference_models(root)
    jc, jw = jtw.load_reference_models(root)
    for t, j in ((tc, jc), (tw, jw)):
        for f in FIELDS:
            a, b = getattr(t, f), getattr(j, f)
            if isinstance(b, np.ndarray):
                assert a.dtype == b.dtype and np.array_equal(a, b), f
            else:
                assert a == b, f
    assert tc.iso_x is not None and tc.feature_names == ("L", "a", "b")
    assert tw.feature_names == ("L", "a", "b", "gray")
    tc.tables                                  # the fused kernel's tables pack


def test_force_calibrations_load_the_same(root):
    p = os.path.join(root, tconfig.PHASE_TO_HEIGHT_JSON)
    assert artifacts.load_phase_to_height(p) == jart.load_phase_to_height(p)
    f = os.path.join(root, tconfig.HEIGHT_TO_FORCE_JSON)
    assert artifacts.load_force_calibration(f) == jart.load_force_calibration(f)
    jcfg = scaled_ftp_config(240, 320)
    jp = JaxForcePipeline.from_artifacts(root, jcfg)
    tp = ForcePipeline.from_artifacts(root, ftp_config_from_dict(dataclasses.asdict(jcfg)),
                                      device="cpu")
    assert tp.force_model == jp.force_model == gates.FORCE
    assert tp.ftp.p2h_model == jp.ftp.p2h_model == gates.P2H


def test_resolve_latest_takes_the_newest(tmp_path):
    for i, name in enumerate(("a_deg2.joblib", "b_deg3.joblib", "c_deg4.joblib")):
        p = tmp_path / name
        p.write_bytes(b"x")
        os.utime(p, (1000.0 + 10 * i, 1000.0 + 10 * ((i + 1) % 3)))
    pattern = str(tmp_path / "*_deg*.joblib")
    assert temp_weights.resolve_latest(pattern) == jtw.resolve_latest(pattern) \
        == str(tmp_path / "b_deg3.joblib")


def test_pipelines_from_artifacts_equal_constructor_built(root):
    jf, jt = scaled_ftp_config(240, 320), scaled_temp_config(240, 320)
    fcfg = ftp_config_from_dict(dataclasses.asdict(jf))
    tcfg = temp_config_from_dict(dataclasses.asdict(jt))
    color, wide = temp_weights.load_reference_models(root)
    force_cfg = force_config_from_dict(dataclasses.asdict(JaxForceConfig()))
    ref, de = synthetic_pair(240, 320, fcfg, seed=0)
    frame = gates.compose_multimodal_frame(de, synthetic_tlc_frame(240, 320, tcfg, seed=0))

    mm = MultimodalPipeline.from_artifacts(root, fcfg, force_cfg, tcfg, device="cpu")
    built = MultimodalPipeline(ForcePipeline(fcfg, force_cfg, gates.P2H, gates.FORCE,
                                             device="cpu"),
                               TemperaturePipeline(tcfg, color, wide, device="cpu"))
    a, b = mm(ref, frame), built(ref, frame)
    for part in ("force", "temperature"):
        assert set(a[part]) == set(b[part])
        for k, v in b[part].items():
            np.testing.assert_array_equal(a[part][k], v, err_msg=f"{part}.{k}")
    assert a["temperature_stats"] == b["temperature_stats"]
    temp = TemperaturePipeline.from_artifacts(root, tcfg, device="cpu")
    assert temp.stats(frame) == built.temperature.stats(frame)
    # the defaults are the parity presets, on the card unless told
    import inspect
    for fn in (ForcePipeline.from_artifacts, TemperaturePipeline.from_artifacts,
               MultimodalPipeline.from_artifacts):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    assert ForcePipeline.from_artifacts(root, device="cpu").ftp.cfg == tconfig.FTPConfig()


def _raises_like_jax(fn, jfn, *args):
    with pytest.raises(Exception) as want:
        jfn(*args)
    with pytest.raises(want.type):
        fn(*args)
    return want.type


def test_missing_and_corrupt_artifacts_raise_as_jax(tmp_path):
    root = str(tmp_path)
    # nothing there
    assert _raises_like_jax(temp_weights.load_reference_models,
                            jtw.load_reference_models, root) is RuntimeError
    assert _raises_like_jax(lambda r: ForcePipeline.from_artifacts(r, device="cpu"),
                            JaxForcePipeline.from_artifacts, root) is FileNotFoundError
    _write_root(root)
    # a force JSON without best_model, then one that is not JSON
    f = os.path.join(root, tconfig.HEIGHT_TO_FORCE_JSON)
    with open(f, "w") as fh:
        json.dump({"rmse": 1.0}, fh)
    assert _raises_like_jax(artifacts.load_force_calibration, jart.load_force_calibration,
                            f) is ValueError
    with open(f, "w") as fh:
        fh.write("{not json")
    assert _raises_like_jax(artifacts.load_force_calibration, jart.load_force_calibration,
                            f) is json.JSONDecodeError
    assert artifacts.load_json_safe(f) is None and jart.load_json_safe(f) is None
    assert artifacts.load_json_safe(f + ".missing") is None
    # a bundle of the wrong form, then a WIDE model on the wrong features
    import joblib
    c = temp_weights.resolve_latest(os.path.join(root, tconfig.TEMP_COLOR_MODEL_GLOB))
    good = joblib.load(c)
    joblib.dump({"weights": 1}, c)
    assert _raises_like_jax(temp_weights.from_joblib, jtw.from_joblib, c) is RuntimeError
    joblib.dump(good, c)
    w = temp_weights.resolve_latest(os.path.join(root, tconfig.TEMP_WIDE_MODEL_GLOB))
    bundle = joblib.load(w)
    bundle["use_features"] = ("L", "a", "b")
    joblib.dump(bundle, w)
    with pytest.raises(RuntimeError, match="Wide model"):
        temp_weights.load_reference_models(root)
    with pytest.raises(RuntimeError, match="Wide model"):
        jtw.load_reference_models(root)
    # bytes that are not a pickle
    with open(c, "wb") as fh:
        fh.write(b"\x00not a joblib file")
    _raises_like_jax(temp_weights.from_joblib, jtw.from_joblib, c)
