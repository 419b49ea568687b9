"""K8's plain version (``vistaf_torch/kernels/temp_kernel.py``) against the
JAX Pallas kernel in interpret mode, and the weights carried across with
``from_numpy``.

Tolerance, as ``test_pallas_temp.py`` holds the Pallas kernel to the jnp
path: finite masks differ on < 2e-3 of pixels, |diff| > 1e-2 on < 2e-3 of
the pixels finite in both, the 99.5th percentile of |diff| < 0.5, and the
colour support differs on < 2e-3.  The two sides run the same float32
operations; exp, log and pow come from different libraries, so a LAB
value that sits on a .5 rounding boundary can flip one 8-bit step.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vistaf_tpu.calib.temp_weights import TempModelWeights as JaxWeights
from vistaf_tpu.config import TempConfig as JaxTempConfig
from vistaf_tpu.pallas.temp_kernel import fused_temperature_maps as jax_fused

from vistaf_torch import kernels
from vistaf_torch.calib.temp_weights import TempModelWeights, from_numpy
from vistaf_torch.kernels.temp_kernel import fused_temperature_maps, op_count
from vistaf_torch.utils.synthetic import synthetic_deploy_temp_weights, synthetic_temp_weights


def _assert_close(ours, ref):
    both = np.isfinite(ours) & np.isfinite(ref)
    assert (np.isfinite(ours) != np.isfinite(ref)).mean() < 2e-3
    d = np.abs(ours[both] - ref[both])
    assert (d > 1e-2).mean() < 2e-3
    assert np.percentile(d, 99.5) < 0.5


def _weights(kind):
    """(color, wide) port weights of each case."""
    if kind == "degree1":
        return synthetic_temp_weights()
    color, wide = synthetic_deploy_temp_weights(seed=5)
    # a zero coefficient (skipped) and a duplicate knot (its segment skipped)
    coef = wide.coef.copy()
    coef[7] = 0.0
    wide = dataclasses.replace(wide, coef=coef)
    iso_x = color.iso_x.copy()
    iso_x[20] = iso_x[19]
    color = dataclasses.replace(color, iso_x=iso_x)
    if kind == "nan_rule":
        # WIDE with a calibrator too: NaN pixels of the input give NaN
        # predictions, which the isotonic map sends to y[0]
        wide = dataclasses.replace(wide, iso_x=color.iso_x + 2.0, iso_y=color.iso_y)
    return color, wide


def _inputs(kind, rng):
    h, w = (64, 128) if kind == "degree1" else (64, 256)
    bgr = np.round(rng.random((h, w, 3)) * 255).astype(np.float32)
    if kind == "nan_rule":
        bgr[3, 10:20, 1] = np.nan
    roi_eff = rng.random((h, w)) > 0.2
    csup_pre = roi_eff & (rng.random((h, w)) > 0.5)
    return bgr, roi_eff, csup_pre


@pytest.mark.parametrize("kind", ["degree1", "deploy_form", "nan_rule"])
def test_k8_plain_matches_pallas_interpret(kind, rng):
    color, wide = _weights(kind)
    bgr, roi_eff, csup_pre = _inputs(kind, rng)
    cfg = JaxTempConfig(image_height=bgr.shape[0], image_width=bgr.shape[1])
    jc, jw = (JaxWeights(**dataclasses.asdict(m)) for m in (color, wide))
    ref = [np.asarray(a) for a in jax_fused(jnp.asarray(bgr), jnp.asarray(roi_eff),
                                            jnp.asarray(csup_pre), cfg, jc, jw,
                                            interpret=True)]
    kernels.reset_launches()
    got = [a.numpy() for a in fused_temperature_maps(
        torch.as_tensor(bgr), torch.as_tensor(roi_eff), torch.as_tensor(csup_pre),
        cfg.color_chroma_min, color, wide)]
    assert kernels.LAUNCHES["fused_temperature"] == 0    # CPU: the plain version
    _assert_close(got[0], ref[0])
    _assert_close(got[1], ref[1])
    assert (got[2] != ref[2]).mean() < 2e-3
    assert np.isnan(got[0][~roi_eff]).all() and np.isnan(got[1][~got[2]]).all()
    if kind == "nan_rule":
        nan_px = np.isnan(bgr).any(axis=-1) & roi_eff
        y0 = np.float32(wide.iso_y[0])
        assert nan_px.any()
        assert (got[0][nan_px] == y0).all() and (ref[0][nan_px] == y0).all()
    if kind != "degree1":
        # the calibrated COLOR map lies in the knots' output range
        vals = got[1][got[2]]
        assert vals.min() >= color.iso_y.min() - 1e-4
        assert vals.max() <= color.iso_y.max() + 1e-4


@pytest.mark.parametrize("kind", ["degree1", "deploy_form"])
def test_from_numpy_round_trips_every_field(kind, tmp_path):
    color, wide = _weights(kind)
    for m in (color, wide):
        jax_w = JaxWeights(**dataclasses.asdict(m))
        back = from_numpy(dataclasses.asdict(jax_w))
        assert isinstance(back, TempModelWeights)
        for f in dataclasses.fields(JaxWeights):
            a, b = getattr(jax_w, f.name), getattr(back, f.name)
            if isinstance(a, np.ndarray):
                assert np.array_equal(a, b) and np.asarray(b).dtype.kind == a.dtype.kind, f.name
            else:
                assert a == b, f.name
        t = back.tables
        keep = np.asarray(m.coef) != 0.0
        assert t.coef.dtype == np.float32 and t.coef.size == keep.sum()
        assert np.array_equal(t.coef, np.asarray(m.coef)[keep].astype(np.float32))
        if m.iso_x is not None:
            assert t.iso_seg.shape == (int((np.diff(m.iso_x) > 0).sum()), 4)
            assert t.iso_y0 == np.float32(m.iso_y[0])
        # and through the JAX package's npz files
        jax_w.save_npz(str(tmp_path / "w.npz"))
        loaded = TempModelWeights.load_npz(str(tmp_path / "w.npz"))
        for f in dataclasses.fields(JaxWeights):
            a, b = getattr(jax_w, f.name), getattr(loaded, f.name)
            assert (np.array_equal(a, b) if isinstance(a, np.ndarray) else a == b), f.name
    with pytest.raises(ValueError, match="unknown"):
        from_numpy({**dataclasses.asdict(wide), "bias": 1.0})
    with pytest.raises(ValueError, match="inconsistent"):
        from_numpy({**dataclasses.asdict(wide), "coef": np.ones(3)})


def test_op_count_of_the_deploy_form():
    color, wide = synthetic_deploy_temp_weights()
    assert (wide.tables.coef.size, color.tables.coef.size) == (35, 10)
    n = 1608 * 1664
    ops = op_count(wide, color, n, n, n // 2)
    assert 100 * n < ops < 300 * n
