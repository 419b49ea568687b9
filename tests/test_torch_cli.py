"""The port's CLI (``vistaf_torch/runner/cli.py``) against the JAX CLI on the
CPU.

- The surface: every subcommand's ``--help`` exits 0 and names
  ``--device``, and missing arguments exit non-zero (as
  ``tests/test_cli.py``); ``_cfgs`` builds the port's copies of the two
  presets; on missing inputs each trainer subcommand raises the exception
  type the JAX CLI raises on the same arguments; ``--device cuda`` without
  a card raises.
- ``train-temp-color --device cpu`` through both CLIs on the 64x64 series
  of ``tests/test_torch_trainers_temp.py``, both packages' trainer given
  that file's small annulus, temperatures and degrees (the CLI's defaults
  are the 4K annulus and the real series), compared as that file compares
  the trainers' outputs.
- ``main()`` of both packages runs ``force --export-heightmaps --debug``,
  ``temperature --debug`` and ``multimodal`` on a reference-layout data
  root written by ``test_torch_artifacts._write_root`` (joblib bundles made
  by the JAX trainer's ``export_joblib_bundle``), the port with ``--device
  cpu``.  ``FTPConfig()`` and ``TempConfig()`` are 4K geometries, so both
  packages' ``_cfgs`` are patched to ``scaled_ftp_config(240, 320)`` and
  ``scaled_temp_config(240, 320)`` (the parity presets scaled), on the
  composed frame of ``test_torch_multimodal_parity.py``.  The output trees
  are compared as in ``test_torch_runner.py``: the same relative files;
  JSON with the same keys and types, numbers within the multimodal gates
  (``torch_runner_gates``); mask PNGs decoded equal; ``debug_log.txt`` with
  the same lines, its carrier peaks within 0.01 bin and its period within
  1%.
"""
import argparse
import csv
import dataclasses
import os

import cv2
import numpy as np
import pytest
import torch

from vistaf_tpu.config import FTPConfig as JaxFTPConfig
from vistaf_tpu.config import TempConfig as JaxTempConfig
from vistaf_tpu.runner import cli as jcli
from vistaf_tpu.utils.synthetic import scaled_ftp_config, scaled_temp_config

from vistaf_torch.config import FTPConfig, TempConfig, ftp_config_from_dict, temp_config_from_dict
from vistaf_torch.runner import cli
from vistaf_torch.runner.io import FORCE_CSV_FIELDS
from vistaf_torch.utils.synthetic import synthetic_pair, synthetic_tlc_frame

import chip_smoke
import torch_runner_gates as rg
import torch_slice_gates as gates
from test_debug_artifacts import FTP_DEBUG_SET, TEMP_DEBUG_SET, TEMP_RAW_SET
from test_torch_artifacts import _write_root
from torch_threads import single_torch_thread  # noqa: F401  (autouse)

H, W = 240, 320
SUBCOMMANDS = ["force", "temperature", "multimodal", "train-p2h", "train-h2f",
               "train-temp-color", "train-temp-black", "pretest"]
# each trainer subcommand on inputs that do not exist (under a temporary
# directory) and the exception the JAX CLI raises there
TRAINERS = {
    "train-p2h": (["--ref", "{d}/r.jpg", "--deformed-dir", "{d}", "--out", "{d}/o"],
                  RuntimeError),
    "train-h2f": (["--ref", "{d}/r.jpg", "--deformed-dir", "{d}", "--p2h-json",
                   "{d}/p.json", "--out", "{d}/o"], FileNotFoundError),
    "train-temp-color": (["--heating", "{d}/h-*.jpg", "--cooling", "{d}/c-*.jpg",
                          "--out", "{d}/o"], RuntimeError),
    "train-temp-black": (["--heating", "{d}/h-*.jpg", "--cooling", "{d}/c-*.jpg",
                          "--out", "{d}/o"], RuntimeError),
    "pretest": (["--pattern", "{d}/*.jpg"], RuntimeError),
}


@pytest.mark.parametrize("cmd", SUBCOMMANDS)
def test_cli_help_exits_zero(cmd, capsys):
    with pytest.raises(SystemExit) as e:
        cli.main([cmd, "--help"])
    assert e.value.code == 0
    assert "--device" in capsys.readouterr().out


@pytest.mark.parametrize("argv", [["force"], ["temperature"], ["multimodal", "--ref", "r"],
                                  [], ["no-such-command"]])
def test_cli_requires_args(argv, capsys):
    with pytest.raises(SystemExit) as e:
        cli.main(argv)
    assert e.value.code != 0
    capsys.readouterr()


@pytest.mark.parametrize("preset", ["parity", "deploy"])
def test_cfgs_are_the_jax_presets(preset):
    ns = argparse.Namespace(preset=preset)
    (tf, tt), (jf, jt) = cli._cfgs(ns), jcli._cfgs(ns)
    assert dataclasses.asdict(tf) == dataclasses.asdict(jf)
    assert dataclasses.asdict(tt) == dataclasses.asdict(jt)
    if preset == "deploy":
        assert (tf, tt) == (FTPConfig().deploy(), TempConfig().deploy())
    else:
        assert (tf, tt) == (FTPConfig(), TempConfig())
        assert (jf, jt) == (JaxFTPConfig(), JaxTempConfig())


@pytest.mark.parametrize("cmd", sorted(TRAINERS))
def test_trainer_subcommands_raise_as_jax_on_missing_inputs(cmd, tmp_path):
    argv, exc = TRAINERS[cmd]
    for tag, mod, extra in (("jax", jcli, []), ("torch", cli, ["--device", "cpu"])):
        d = tmp_path / tag
        d.mkdir()
        with pytest.raises(exc) as e:
            mod.main([cmd, *(a.format(d=d) for a in argv), *extra])
        assert type(e.value) is exc, (tag, e.value)


def test_train_temp_color_command_matches_jax(tmp_path, monkeypatch):
    import functools
    from vistaf_tpu.trainers import temperature_color as jcolor
    from vistaf_torch.trainers import temperature_color as tcolor
    import test_torch_trainers_temp as tt
    heat, cool = str(tmp_path / "heat"), str(tmp_path / "cool")
    tt.write_series(heat, "heating", tt.TEMPS, tt.FRAMES, seed=1)
    tt.write_series(cool, "cooling", tt.TEMPS[::-1], tt.FRAMES, seed=2,
                    t_span=(tt.TEMPS[0], tt.TEMPS[-1]))
    small = dict(temps_heating=tt.TEMPS, frames_per_temp=tt.FRAMES,
                 fit_temp_range=(tt.TEMPS[0], tt.TEMPS[-1]), degree_candidates=(1, 2),
                 inner_circle=tt.INNER, outer_circle=tt.OUTER)
    for mod in (jcolor, tcolor):
        monkeypatch.setattr(mod, "train", functools.partial(mod.train, **small))
    outs = {}
    for tag, mod, extra in (("jax", jcli, []), ("torch", cli, ["--device", "cpu"])):
        outs[tag] = str(tmp_path / tag)
        assert mod.main(["train-temp-color", "--heating", os.path.join(heat, "heating-*.jpg"),
                         "--cooling", os.path.join(cool, "cooling-*.jpg"),
                         "--out", outs[tag], *extra]) == 0
    j, t = outs["jax"], outs["torch"]
    assert tt.trained_files(t) == tt.trained_files(j)
    tt._assert_numbers_close(tt._summary(t), tt._summary(j), tt.METRIC_ATOL)
    for name in sorted(n for n in os.listdir(j) if n.endswith(".npz")):
        tt._assert_weights(tt.TempModelWeights.load_npz(os.path.join(t, name)),
                           tt.JaxWeights.load_npz(os.path.join(j, name)))


def test_device_cuda_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: --device cuda runs")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["force", "--ref", "r.png", "--def", "d.png", "--out", str(tmp_path),
                  "--device", "cuda"])


# ---------------------------------------------------------------------------
# the three commands, end to end, against the JAX CLI
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Output roots of both CLIs' force, temperature and multimodal
    commands (and of the port's force without --debug) on one data root."""
    root = tmp_path_factory.mktemp("cli")
    data = str(root / "data")
    _write_root(data)
    jf, jt = scaled_ftp_config(H, W), scaled_temp_config(H, W)
    tf = ftp_config_from_dict(dataclasses.asdict(jf))
    tt = temp_config_from_dict(dataclasses.asdict(jt))
    ref_g, de_g = synthetic_pair(H, W, tf, seed=0)
    tlc = synthetic_tlc_frame(H, W, tt, seed=0)
    ref_p, def_p = str(root / "ref.png"), str(root / "def.png")
    assert cv2.imwrite(ref_p, gates.compose_multimodal_frame(ref_g, tlc))
    assert cv2.imwrite(def_p, gates.compose_multimodal_frame(de_g, tlc))
    commands = {
        "force": ["force", "--ref", ref_p, "--def", def_p, "--export-heightmaps", "--debug"],
        "temperature": ["temperature", "--image", def_p, "--debug"],
        "multimodal": ["multimodal", "--ref", ref_p, "--def", def_p],
    }
    outs = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcli, "_cfgs", lambda args: (jf, jt))
        mp.setattr(cli, "_cfgs", lambda args: (tf, tt))
        for name, argv in commands.items():
            for tag, mod, extra in (("jax", jcli, []), ("torch", cli, ["--device", "cpu"])):
                out = str(root / tag / name)
                assert mod.main([*argv, "--out", out, "--data-root", data, *extra]) == 0
                outs[(tag, name)] = out
        out = str(root / "torch" / "force_nodebug")
        assert cli.main(["force", "--ref", ref_p, "--def", def_p, "--export-heightmaps",
                         "--out", out, "--data-root", data, "--device", "cpu"]) == 0
        outs[("torch", "force_nodebug")] = out
    return outs


def test_force_command_tree_and_result(runs):
    j, t = runs[("jax", "force")], runs[("torch", "force")]
    assert rg.tree(t) == rg.tree(j)
    assert {f"ftp_run/{n}" for n in FTP_DEBUG_SET} <= rg.tree(t)
    assert set(chip_smoke.FTP_DEBUG_FILES) == FTP_DEBUG_SET
    # the force contract chip_smoke.py holds on the card
    assert rg.tree(runs[("torch", "force_nodebug")]) == set(chip_smoke.FORCE_CLI_FILES)
    assert rg.tree(j) - {f"ftp_run/{n}" for n in FTP_DEBUG_SET} == \
        set(chip_smoke.FORCE_CLI_FILES)
    rg.assert_result_json_within_gates(rg.load_json(os.path.join(t, "result.json")),
                                       rg.load_json(os.path.join(j, "result.json")), t, j)
    rows = []
    for root in (t, j):
        with open(os.path.join(root, "result.csv"), newline="", encoding="utf-8") as f:
            rows.append(list(csv.DictReader(f)))
    (tr,), (jr,) = rows
    assert list(tr) == list(jr) == FORCE_CSV_FIELDS
    for k in jr:
        if k in rg.RESULT_NUMBERS:
            rg.assert_close_rel(float(tr[k]), float(jr[k]), rg.FORCE_RTOL, k)
        else:
            assert rg.normalise(tr[k], t) == rg.normalise(jr[k], j), k


def test_force_command_heightmaps_and_debug_log(runs):
    j, t = runs[("jax", "force")], runs[("torch", "force")]
    a, b = (np.load(os.path.join(r, "ftp_run", "height_map_crop.npy")) for r in (t, j))
    assert a.shape == b.shape and a.dtype == b.dtype == np.float32
    fa, fb = np.isfinite(a), np.isfinite(b)
    assert np.mean(fa == fb) >= 0.995
    scale = np.nanmax(np.abs(b))
    assert np.abs(a[fa & fb] - b[fa & fb]).max() <= rg.FORCE_RTOL * scale
    np.testing.assert_array_equal(
        np.loadtxt(os.path.join(t, "ftp_run", "height_map_crop.csv"), delimiter=",",
                   dtype=np.float32), a)
    with np.load(os.path.join(t, "ftp_run", "height_map_bundle.npz")) as zt, \
            np.load(os.path.join(j, "ftp_run", "height_map_bundle.npz")) as zj:
        assert zt.files == zj.files == ["height_crop"]
        np.testing.assert_array_equal(zt["height_crop"], a)
    lt, lj = (open(os.path.join(r, "ftp_run", "debug_log.txt")).read().splitlines()
              for r in (t, j))
    assert len(lt) == len(lj) == 4 and lt[0] == lj[0]
    # the sub-bin carrier peaks within 0.01 bin, the period within 1%
    for i, head in ((1, "[FFT] carrier k ref = "), (2, "[FFT] carrier k def = ")):
        assert lt[i].startswith(head) and lj[i].startswith(head)
        kt, kj = (np.array(x[len(head):].strip("[]").split(), float) for x in (lt[i], lj[i]))
        np.testing.assert_allclose(kt, kj, rtol=0, atol=0.01)
    head = "[FFT] estimated grating period = "
    assert lt[3].startswith(head) and lj[3].startswith(head)
    rg.assert_close_rel(float(lt[3][len(head):]), float(lj[3][len(head):]), rg.FORCE_RTOL,
                        "period")


def test_temperature_command_tree_masks_and_maps(runs):
    j, t = runs[("jax", "temperature")], runs[("torch", "temperature")]
    files = rg.tree(t)
    assert files == rg.tree(j)
    assert TEMP_DEBUG_SET | TEMP_RAW_SET <= files
    masks = sorted(chip_smoke.MASK_PNGS)
    assert set(masks) <= files
    rg.assert_same_pngs(t, j, [*masks, "debug_fused_source.png"])
    for name in ("temperature_map_final.npy", "temperature_map_fused.npy"):
        a, b = (np.load(os.path.join(r, name)) for r in (t, j))
        assert a.shape == b.shape == (H, W) and a.dtype == b.dtype == np.float32
        both = np.isfinite(a) & np.isfinite(b)
        assert np.mean(np.isfinite(a) == np.isfinite(b)) >= 1 - rg.VALID_RTOL, name
        assert np.abs(a[both] - b[both]).max() <= rg.T_EXTREME_ATOL, name


def _session(out):
    (name,) = os.listdir(out)
    assert name.startswith("session_")
    return os.path.join(out, name)


def test_multimodal_command_tree_and_summary(runs):
    j, t = (_session(runs[(tag, "multimodal")]) for tag in ("jax", "torch"))
    assert rg.tree(t) == rg.tree(j)
    summaries = []
    for s in (t, j):
        doc = rg.load_json(os.path.join(s, "combined_outputs", "multimodal_summary.json"))
        assert "session_" + doc["session_id"] == os.path.basename(s)
        doc["session_id"] = "<ID>"
        summaries.append(rg.normalise(doc, s))
    g, w = summaries
    rg.assert_same_types(g, w)
    assert g["calibration_performance"] == w["calibration_performance"]
    rg.assert_readings_within_gates(g.pop("sensor_readings"), w.pop("sensor_readings"))
    assert g == w
    rg.assert_same_pngs(os.path.join(t, "temperature_sensing"),
                        os.path.join(j, "temperature_sensing"), chip_smoke.MASK_PNGS)
    rg.assert_result_json_within_gates(
        rg.load_json(os.path.join(t, "force_sensing", "result.json")),
        rg.load_json(os.path.join(j, "force_sensing", "result.json")), t, j)
