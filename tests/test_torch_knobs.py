"""The force knobs off the presets' path, in the port against the JAX
package on the CPU: the ECC's translation and affine modes under both
samplers and the gather sampler at a stride, the single-frame (unlocked)
demod, the Gaussian sideband, the Hann window and the preprocessing without
the DC removal, op by op; then the port's FTPPipeline against JAX's under
four configurations that combine them (the 2160x3840 ones of
``chip_smoke.py``'s ``knobs`` phase, scaled to 240x320 with the JAX tests'
reduced budgets), and JAX's own prealignment scene with a residual shift
injected.

Tolerances, each stated where it is held: force within 0.1% (a tenth of the
deploy contract), ECC translations within 0.05 px and the rotation within
5e-5 rad, carrier peaks within 1e-3 bins, reliable masks equal on at least
99.9% of the pixels, and each op's float32 output within its stated atol
(summation order: XLA's against PyTorch's, pocketfft against XLA's FFT).
The crop ECC is held free-running; the force, the masks and the maps given
JAX's alignment (``torch_slice_gates.run_port_given_alignment``), since the
synthetic grating leaves the ECC's ty nearly flat: under the deploy preset
at 240x320 the free-running port stops 0.023 px from JAX in ty (19
iterations against 6), 0.18% apart in force, and 0.0009% given JAX's warp.
"""
import dataclasses

import cv2
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from vistaf_tpu.ftp import demod as jdemod
from vistaf_tpu.ftp.pipeline import FTPPipeline as JaxFTPPipeline
from vistaf_tpu.ops import color as jcolor
from vistaf_tpu.ops import filters as jfilt
from vistaf_tpu.ops import registration as jreg
from vistaf_tpu.ops.geometry import circular_apodization
from vistaf_tpu.utils.synthetic import scaled_ftp_config, synthetic_pair

import torch_slice_gates as gates
from torch_threads import single_torch_thread  # noqa: F401  (autouse)
from vistaf_torch import config as tcfg
from vistaf_torch.ftp import demod as tdemod
from vistaf_torch.ftp.pipeline import FTPPipeline
from vistaf_torch.ops import registration as treg
from vistaf_torch.ops.consts import DeviceConsts

T = torch.as_tensor
H, W = 240, 320
# the JAX prealignment test's reduced budgets (tests/test_prealign_holes.py)
BUDGETS = dict(ecc_iters=40, unwrap_cg_iters=8, inpaint_iters=8, grating_prealign_ecc_iters=40)
FORCE_RTOL, ECC_ATOL_PX, ROT_ATOL, PEAK_ATOL, RELIABLE_MIN = 1e-3, 0.05, 5e-5, 1e-3, 0.999


def J(a):
    """A writable numpy copy (JAX hands out read-only buffers)."""
    return np.array(a)


def port_cfg(jc):
    return tcfg.ftp_config_from_dict(dataclasses.asdict(jc))


@pytest.fixture
def consts():
    return DeviceConsts("cpu")


# --------------------------------------------------------------- ECC modes
def _textured_pair(seed, h=120, w=140):
    """A blurred noise plane and the same plane under a known small affine
    warp (inverse map, reflect border), both scaled to [0, 1] and blurred as
    the pipeline blurs its ECC inputs; with a 10 px mask border."""
    rng = np.random.default_rng(seed)
    ref = cv2.GaussianBlur(rng.random((h, w)).astype(np.float32), (0, 0), 3) * 255
    M = np.array([[1.004, 0.006, 1.2], [-0.005, 0.997, -0.7]], np.float32)
    mov = cv2.warpAffine(ref, M, (w, h), flags=cv2.INTER_LINEAR | cv2.WARP_INVERSE_MAP,
                         borderMode=cv2.BORDER_REFLECT)
    blur = [J(jfilt.gaussian_blur(jnp.asarray(a / 255.0), 3.0)).astype(np.float32)
            for a in (ref, mov)]
    mask = np.zeros((h, w), bool)
    mask[10:-10, 10:-10] = True
    return blur[1], blur[0], mask, M


@pytest.mark.parametrize("mode,sampler,stride", [
    ("translation", "gather", 1), ("translation", "gather", 2), ("translation", "shear", 1),
    ("affine", "gather", 1), ("affine", "gather", 2), ("affine", "shear", 2),
    ("euclidean", "gather", 2)])
def test_ecc_modes_match_jax(mode, sampler, stride):
    """``ecc_align`` in each motion type, the gather sampler also on the
    stride-2 grid (JAX subsamples the template and coordinates there), held
    to the JAX ``ecc_align``: translations within 0.05 px, the linear part
    within 5e-5, rho within 1e-4; the affine solve recovers the known warp
    within 0.03 (``tests/test_ops_registration.py``'s bound)."""
    tmpl, img, mask, M = _textured_pair(5)
    kw = dict(mode=mode, max_iters=100, eps=1e-7, stride=stride, sampler=sampler,
              shear_k=4, stall_patience=0, loop_kernel=False)
    jw, jrho, _ = jreg.ecc_align(jnp.asarray(tmpl), jnp.asarray(img), jnp.asarray(mask), **kw)
    w, rho, it = treg.ecc_align(T(tmpl), T(img), T(mask), **kw)
    jw = J(jw)
    np.testing.assert_allclose(w.numpy()[:, 2], jw[:, 2], atol=ECC_ATOL_PX)
    np.testing.assert_allclose(w.numpy()[:, :2], jw[:, :2], atol=ROT_ATOL)
    assert abs(float(rho) - float(jrho)) < 1e-4 and float(rho) > 0.99
    assert 1 <= int(it) < 100
    if mode == "affine":
        np.testing.assert_allclose(w.numpy(), M, atol=0.03)


def test_ecc_unknown_mode_raises():
    tmpl, img, mask, _ = _textured_pair(6, 40, 48)
    with pytest.raises(ValueError, match="homography"):
        treg.ecc_align(T(tmpl), T(img), T(mask), mode="homography")


# --------------------------------------------------------------- demod
def _crop_frames(jc):
    """The 480x640 synthetic pair's gray 236x236 crops and apodization."""
    ref, de = synthetic_pair(480, 640, jc)
    gray = [J(jcolor.bgr_to_gray(jnp.asarray(f)))[143:379, 204:440] for f in (ref, de)]
    return gray, circular_apodization(236, 236, 118, 118, 117, jc.apod_taper_px)


def _assert_demod_close(got, want):
    """Refined peak within 1e-3 bins (equal rounded bins), the complex
    field within 1e-4 of its largest modulus."""
    np.testing.assert_array_equal(np.round(got.peak_f.numpy()), np.round(J(want.peak_f)))
    np.testing.assert_allclose(got.peak_f.numpy(), J(want.peak_f), atol=PEAK_ATOL)
    np.testing.assert_allclose(got.k.numpy(), J(want.k), atol=PEAK_ATOL)
    ref = J(want.complex_demod)
    np.testing.assert_allclose(got.complex_demod.numpy(), ref, rtol=0,
                               atol=1e-4 * np.abs(ref).max())


@pytest.mark.parametrize("sideband", ["patch_shift", "gauss"])
def test_single_frame_demod_matches_jax(consts, sideband):
    """The unlocked demod of each frame on its own spectrum, then the
    deformed frame at the reference's carrier, under either sideband."""
    jc = scaled_ftp_config(480, 640).replace(sideband_method=sideband)
    (g0, g1), apo = _crop_frames(jc)
    for g in (g0, g1):
        want = jdemod.ftp_complex_demod(jnp.asarray(g), jnp.asarray(apo), jc)
        got = tdemod.ftp_complex_demod(T(g), T(apo), port_cfg(jc), consts)
        assert got.fft_shape == want.fft_shape
        _assert_demod_close(got, want)
    lock = jdemod.ftp_complex_demod(jnp.asarray(g0), jnp.asarray(apo), jc).peak_f
    want = jdemod.ftp_complex_demod(jnp.asarray(g1), jnp.asarray(apo), jc, carrier_refined=lock)
    got = tdemod.ftp_complex_demod(T(g1), T(apo), port_cfg(jc), consts,
                                   carrier_refined=T(J(lock)))
    _assert_demod_close(got, want)


@pytest.mark.parametrize("peak_method", ["topk", "cascade"])
def test_gauss_pair_matches_jax(consts, peak_method):
    """The locked pair with the Gaussian sideband (always the full
    ``fft2``, even where the patch shift would take the half spectrum)."""
    jc = scaled_ftp_config(480, 640).replace(sideband_method="gauss", peak_method=peak_method)
    (g0, g1), apo = _crop_frames(jc)
    want = jdemod.ftp_complex_demod_pair(jnp.asarray(g0), jnp.asarray(g1), jnp.asarray(apo), jc)
    got = tdemod.ftp_complex_demod_pair(T(g0), T(g1), T(apo), port_cfg(jc), consts)
    for a, b in zip(got, want):
        _assert_demod_close(a, b)


@pytest.mark.parametrize("change", [dict(use_hann_window=True),
                                    dict(remove_mean_after_apod=False),
                                    dict(use_hann_window=True, remove_mean_after_apod=False,
                                         dc_remove_stat="mean")])
def test_preprocess_knobs_match_jax(consts, change):
    """The Hann window (the plain product of two ``np.hanning``) and the
    preprocessing without the DC removal: the windowed images within 1e-5
    of their largest value."""
    jc = scaled_ftp_config(480, 640).replace(**change)
    (g0, g1), apo = _crop_frames(jc)
    got = tdemod.preprocess(T(np.stack([g0, g1])), T(apo), port_cfg(jc), consts)[0].numpy()
    for a, g in zip(got, (g0, g1)):
        b = J(jdemod._preprocess(jnp.asarray(g), jnp.asarray(apo), jc)[0])
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5 * np.abs(b).max())


# --------------------------------------------------------------- the pipeline
def _scaled(**change):
    return scaled_ftp_config(H, W).replace(**BUDGETS).replace(**change)


def _scaled_deploy(**change):
    return scaled_ftp_config(H, W).deploy().replace(**BUDGETS).replace(**change)


# chip_smoke.py's knobs configurations at 2160x3840 (takeda4k, window4k,
# prealign4k) and 640x480 (prealign640), each on its base preset scaled here
CONFIGS = {
    "takeda": lambda: _scaled(sideband_method="gauss", lock_carrier_to_reference=False,
                              ecc_warp_mode="translation", ecc_stride=2),
    "window": lambda: _scaled(use_hann_window=True, remove_mean_after_apod=False,
                              ecc_warp_mode="affine"),
    "prealign_single_pass": lambda: _scaled_deploy(use_grating_band_prealign=True,
                                                   use_two_pass_detrend=False),
    "prealign_deploy": lambda: _scaled_deploy(use_grating_band_prealign=True),
}


def run_all(jc):
    """(JAX result, the port's free-running result, the port's result given
    JAX's alignment, the free run's launch counts)."""
    jres, tres, launches = gates.run_both(jc)
    return jres, tres, gates.run_port_given_alignment(jc, jres), launches


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def runs(request):
    return request.param, run_all(CONFIGS[request.param]())


def assert_warp_close(tw, jw, translations=(0, 1)):
    """ECC warps: the named translations within 0.05 px; the rotation
    within 5e-5 rad, or an affine warp's linear part within 5e-5 of each
    entry's magnitude (at least 1)."""
    np.testing.assert_allclose(tw[translations, 2], jw[translations, 2], atol=ECC_ATOL_PX)
    rot = np.arctan2(tw[1, 0], tw[0, 0]) - np.arctan2(jw[1, 0], jw[0, 0])
    if np.allclose(jw[:, :2], [[jw[0, 0], -jw[1, 0]], [jw[1, 0], jw[0, 0]]], atol=1e-7):
        assert abs(rot) < ROT_ATOL, rot
    else:
        assert (np.abs(tw[:, :2] - jw[:, :2]) <= ROT_ATOL * np.maximum(1, np.abs(jw[:, :2]))).all()


def assert_pipeline_close(jres, tres, given):
    """The knob gates of the module docstring: the ECC free-running
    (``tres``), the rest given JAX's alignment (``given``)."""
    assert_warp_close(tres["dbg_ecc_warp"], jres["dbg_ecc_warp"])
    for res in (tres, given):
        for key in ("dbg_peak_ref", "carrier_k_ref", "carrier_k_def"):
            np.testing.assert_allclose(res[key], jres[key], atol=PEAK_ATOL, err_msg=key)
    assert gates.force_gap(jres, given) < FORCE_RTOL, (given["force_N"], jres["force_N"])
    assert gates.reliable_agreement(jres, given) >= RELIABLE_MIN
    hm_t, hm_j = given["height_map_mm_crop"], jres["height_map_mm_crop"]
    np.testing.assert_array_equal(np.isfinite(hm_t), np.isfinite(hm_j))


def test_knob_configurations_match_jax(runs):
    name, (jres, tres, given, launches) = runs
    assert_pipeline_close(jres, tres, given)
    assert all(v == 0 for v in launches.values()), launches
    if name == "takeda":       # unlocked: each frame keeps its own carrier
        assert not np.array_equal(tres["carrier_k_ref"], tres["carrier_k_def"])


def test_knob_configurations_maps_agree(runs):
    """Given JAX's alignment: the deformed gray after the prealignment's
    warp within 0.05 gray levels, and the zeroed phase on the common
    reliable pixels."""
    _, (jres, _, given, _) = runs
    d = np.abs(given["dbg_def_gray_aligned"] - jres["dbg_def_gray_aligned"])
    assert d.max() < 0.05, d.max()
    rel = given["reliable_crop"] & jres["reliable_crop"]
    assert np.median(np.abs(given["dbg_phase_zeroed"] - jres["dbg_phase_zeroed"])[rel]) < 1e-4


def test_single_pass_detrend_has_no_contact_region(runs):
    """Without the two-pass detrend the contact region is empty on both
    sides; with it both find one."""
    name, (jres, tres, _, _) = runs
    single = name == "prealign_single_pass"
    assert tres["contact_dilated_crop"].any() != single
    assert jres["contact_dilated_crop"].any() != single


def test_prealign_scene_with_residual_shift_matches_jax(monkeypatch):
    """JAX's own prealignment scene (``tests/test_prealign_holes.py``:
    240x320, ``hist`` percentiles, the reduced budgets) with its residual
    (1.6, -1.1) px translation injected into the deformed frame, and the
    global shift and the crop ECC off, so that the prealignment alone
    absorbs it.  Its ECC (gather, euclidean) held free-running to JAX's
    (read out of the jitted graph by a debug callback): tx within 0.05 px,
    the rotation within 5e-5 rad.  Its ty is the grating's flat direction:
    JAX's jitted float32 loop stops after 23 iterations at -1.094 px, the
    port's (float64 sums) and JAX's unjitted loop run the 40 to -1.955 px,
    rho 0.99911 on all three; so ty is not held, and the rest is held given
    JAX's warp: the prealigned gray within 1e-3 gray levels, the reliable
    masks, the finite heightmap pixels equal."""
    import jax
    import vistaf_tpu.ftp.pipeline as jpipe
    jc = scaled_ftp_config(H, W).replace(percentile_method="hist", **BUDGETS).replace(
        use_grating_band_prealign=True, apply_global_shift=False,
        use_ecc_crop_alignment=False)
    ref, de = synthetic_pair(H, W, jc)
    M = np.array([[1.0, 0.0, 1.6], [0.0, 1.0, -1.1]], np.float32)
    de = cv2.warpAffine(de, M, (W, H), flags=cv2.INTER_LINEAR, borderMode=cv2.BORDER_REFLECT)
    warps = {}
    jax_ecc = jpipe.ecc_align

    def recorded(*a, **k):
        out = jax_ecc(*a, **k)
        jax.debug.callback(lambda w: warps.__setitem__("jax", np.array(w)), out[0])
        return out

    monkeypatch.setattr(jpipe, "ecc_align", recorded)
    jres = JaxFTPPipeline(jc, gates.P2H, debug_outputs=True)(ref, de)
    pipe = FTPPipeline(port_cfg(jc), gates.P2H, debug_outputs=True, device="cpu")
    own = pipe._prealign_ecc
    pipe._prealign_ecc = lambda *a: warps.setdefault("port", own(*a))
    pipe(ref, de)
    assert_warp_close(warps["port"].numpy(), warps["jax"], translations=(0,))
    pipe._prealign_ecc = lambda *a: torch.as_tensor(warps["jax"])
    given = pipe(ref, de)
    d = np.abs(given["dbg_def_gray_aligned"] - jres["dbg_def_gray_aligned"])
    assert d.max() < 1e-3, d.max()
    assert gates.reliable_agreement(jres, given) >= RELIABLE_MIN
    np.testing.assert_allclose(given["carrier_k_def"], jres["carrier_k_def"], atol=PEAK_ATOL)
    hm_t, hm_j = given["height_map_mm_crop"], jres["height_map_mm_crop"]
    np.testing.assert_array_equal(np.isfinite(hm_t), np.isfinite(hm_j))
