"""K8's plain version (``vistaf_torch/kernels/temp_kernel.py``) against the
JAX Pallas kernel in interpret mode, the weights carried across with
``from_numpy``, and numpy models of the kernel's host tables: the node
programs that build each monomial from its parent's, and the calibrator's
binary search against the backward scan.

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
from vistaf_torch.calib.temp_weights import poly_powers
from vistaf_torch.kernels.temp_kernel import (fused_temperature_maps, node_program, op_count,
                                              pack_models, poly_eval, segments_sorted)
from vistaf_torch.utils.synthetic import synthetic_deploy_temp_weights, synthetic_temp_weights
from torch_threads import single_torch_thread  # noqa: F401  (autouse)


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


# ---------------------------------------------------------------------------
# The kernel's host tables (csrc/temp.cu runs them; these are their models)

def run_node_program(steps, scaled, intercept):
    """numpy float32 model of the kernel's node program over arrays of scaled
    features: (out, [each term's monomial in table order, None for the
    constant term])."""
    out = np.full_like(scaled[0], np.float32(intercept))
    prev, slots, monomials = out, {}, []
    for code, cbits in steps:
        src, dst, feat = code & 0xFF, (code >> 8) & 0xFF, (code >> 16) & 7
        c = np.int32(cbits).view(np.float32)
        v = slots[src - 2] if src >= 2 else prev
        if feat:
            v = v * scaled[feat - 1] if src else scaled[feat - 1]
        if dst:
            slots[dst - 1] = v
        if (code >> 20) & 1:
            out = out + c * v if (src or feat) else out + c
            monomials.append(v if (src or feat) else None)
        prev = v
    return out, monomials


def left_folds(powers, scaled):
    """Each term's product of its factors in feature order, from the first."""
    folds = []
    for row in powers:
        term = None
        for f, e in enumerate(row):
            for _ in range(int(e)):
                term = scaled[f] if term is None else term * scaled[f]
        folds.append(term)
    return folds


def _tables(kind):
    color, wide = synthetic_deploy_temp_weights(0)
    if kind == "deploy_wide":
        return wide.tables
    if kind == "deploy_color":
        return color.tables
    rng = np.random.default_rng(40)
    if kind == "zeros_and_missing_prefix":
        powers = poly_powers(4, 3)
        coef = rng.normal(size=powers.shape[0])
        rows = [tuple(r) for r in powers]
        # drop x0, x0 x1 and x2 x3 (prefixes of later terms) and two others
        for r in ((1, 0, 0, 0), (1, 1, 0, 0), (0, 0, 1, 1), (0, 2, 1, 0), (0, 0, 0, 3)):
            coef[rows.index(r)] = 0.0
        return dataclasses.replace(wide, coef=coef).tables
    powers = poly_powers(3, 5)                                   # 56 terms
    return dataclasses.replace(color, powers=powers,
                               coef=rng.normal(size=powers.shape[0]), poly_degree=5).tables


@pytest.mark.parametrize("kind", ["deploy_wide", "deploy_color", "zeros_and_missing_prefix",
                                  "color_degree5"])
def test_node_program_reproduces_every_left_fold(kind):
    """Every term's monomial from the node program equals its left fold bit
    for bit, and so does the sum in table order; the plain version's
    ``poly_eval`` gives the same bits."""
    t = _tables(kind)
    steps, n_slots = node_program(t.powers, t.coef)
    assert steps.shape[0] >= t.coef.size and n_slots <= 64
    rng = np.random.default_rng(41)
    n_feat = t.mean.size
    feats = [np.round(rng.uniform(0, 255, size=4096)).astype(np.float32) for _ in range(n_feat)]
    scaled = [(f - t.mean[i]) / t.scale[i] for i, f in enumerate(feats)]
    out, monomials = run_node_program(steps, scaled, t.intercept)
    folds = left_folds(t.powers, scaled)
    assert len(monomials) == len(folds) == t.coef.size
    want = np.full_like(scaled[0], t.intercept)
    for fold, mono, c in zip(folds, monomials, t.coef):
        if fold is None:
            assert mono is None
            want = want + c
        else:
            assert np.array_equal(mono.view(np.int32), fold.view(np.int32))
            want = want + c * fold
    assert np.array_equal(out.view(np.int32), want.view(np.int32))
    plain = poly_eval([torch.as_tensor(f) for f in feats], t).numpy()
    assert np.array_equal(out.view(np.int32), plain.view(np.int32))


def test_node_program_missing_prefix_becomes_compute_only():
    """x0 x1 x2 without x0 or x0 x1 in the table: the chain computes both
    prefixes (no coefficient) and the term adds once."""
    powers = np.array([[0, 0, 0], [1, 1, 1], [1, 1, 2]], np.uint8)
    steps, n_slots = node_program(powers, np.array([0.5, 2.0, -1.0], np.float32))
    terms = [(c >> 20) & 1 for c, _ in steps]
    assert terms == [1, 0, 0, 1, 1] and n_slots == 1


def seg_index_scan(x0, pred):
    """The backward scan: the last segment with pred >= x0, -1 for none."""
    for i in range(len(x0) - 1, -1, -1):
        if pred >= x0[i]:
            return i
    return -1


def seg_index_search(x0, pred):
    """The kernel's binary search: how many x0 are <= pred, less one; a NaN
    prediction keeps y[0] (-1)."""
    if np.isnan(pred):
        return -1
    lo, hi = 0, len(x0)
    while lo < hi:
        mid = (lo + hi) // 2
        if x0[mid] <= pred:
            lo = mid + 1
        else:
            hi = mid
    return lo - 1


@pytest.mark.parametrize("table", ["deploy_color", "float32_ties"])
def test_binary_search_finds_the_scans_segment(table):
    color, _ = synthetic_deploy_temp_weights(0)
    if table == "float32_ties":        # distinct in float64, equal in float32
        iso_x = np.array([0.0, 1.0, 1.0 + 1e-12, 1.0 + 2e-12, 2.0, 3.0])
        color = dataclasses.replace(color, iso_x=iso_x, iso_y=np.arange(6.0))
    x0 = color.tables.iso_seg[:, 0]
    assert segments_sorted(color.tables.iso_seg)
    f32 = np.float32
    preds = [f32(np.nan), x0[0] - f32(1.0), f32(-np.inf), f32(np.inf), x0[-1] + f32(1.0)]
    preds += list(x0) + list((x0[:-1] + x0[1:]) / f32(2.0))
    preds += [np.nextafter(x, f32(-np.inf)) for x in x0]
    for pred in preds:
        assert seg_index_search(x0, pred) == seg_index_scan(x0, pred), pred


def test_unsorted_calibrator_sets_the_scan_flag():
    color, wide = synthetic_deploy_temp_weights(0)
    params, tables, n_slots = pack_models(wide.tables, color.tables, 10.0)
    assert params.color.seg_sorted == 1 and params.color.n_seg == 63
    assert params.wide.has_iso == 0 and n_slots == max(node_program(t.powers, t.coef)[1]
                                                       for t in (wide.tables, color.tables))
    assert tables.size % 4 == 0 and params.color.seg_off % 4 == 0
    # (0, 5) and (5, 6) kept, (6, 1) dropped, (1, 2) kept: x0 = 0, 5, 1
    odd = dataclasses.replace(color, iso_x=np.array([0.0, 5.0, 6.0, 1.0, 2.0]),
                              iso_y=np.arange(5.0))
    assert not segments_sorted(odd.tables.iso_seg)
    params, _, _ = pack_models(wide.tables, odd.tables, 10.0)
    assert params.color.seg_sorted == 0 and params.color.n_seg == 3
