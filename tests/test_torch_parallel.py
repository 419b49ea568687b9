"""The port's stream parallelism (``vistaf_torch.parallel``) and the force
path's ``hist`` percentiles against the JAX package on the CPU.

- The ``hist`` route: ``masked_percentile_hist_rows`` bit-equal to JAX
  (bins 64 and 128, refine 0-2, an empty row); the demod's preprocessing and
  the non-fused IRLS under ``hist`` within the stated float32 tolerances.
- The whole-limb heads over a cheap per-stream force (the torch twin of
  ``multihost_worker.py``'s, in ``torch_multihost_worker.py``): the JAX
  heads on ``make_stream_mesh(8)`` (the conftest's 8 virtual devices), the
  port's on a world-1 gloo mesh, 8 distinct seeded streams at 144x192.
  Maps, gates, the canvas and the depth maxima equal JAX's; the per-stream
  forces and the sums within 1e-6 relative: the cheap force's volume is a
  float32 sum over 27,648 pixels, which XLA and PyTorch add in different
  orders (the head only places them: its forces equal the port cheap
  force's own, bit for bit).
- The head over the real forward: the JAX tests' ``hist`` configuration at
  144x192, 4 distinct ``synthetic_pair`` streams, ``whole_limb_step`` with
  map stride 2; one JAX compile of the forward, shared by the module.
- ``parallel.distributed``: the single-process no-op and torchrun's
  environment.

Every process group a test brings up is torn down by its module fixture.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import NamedSharding, PartitionSpec as P

from vistaf_tpu.calib import scalar_models as jscalar
from vistaf_tpu.ftp import demod as jdemod
from vistaf_tpu.ftp.pipeline import FTPPipeline as JaxFTPPipeline
from vistaf_tpu.ops import color as jcolor
from vistaf_tpu.ops import percentile as jpct
from vistaf_tpu.ops import polyfit as jpoly
from vistaf_tpu.ops.geometry import circular_apodization
from vistaf_tpu.parallel import mesh as jmesh
from vistaf_tpu.pipelines import streaming as jstreaming
from vistaf_tpu.pipelines.force import depth_map_to_volume_cm3 as j_volume
from vistaf_tpu.utils.synthetic import scaled_ftp_config

import vistaf_torch.ftp.pipeline as tftp_pipeline
from vistaf_torch import kernels
from vistaf_torch.config import ftp_config_from_dict
from vistaf_torch.ftp import demod as tdemod
from vistaf_torch.ftp.pipeline import FTPPipeline
from vistaf_torch.ops import percentile as tpct
from vistaf_torch.ops import polyfit as tpoly
from vistaf_torch.ops.consts import DeviceConsts
from vistaf_torch.parallel import distributed as tdist
from vistaf_torch.parallel import mesh as tmesh
from vistaf_torch.pipelines import streaming as tstreaming
from vistaf_torch.utils.synthetic import synthetic_pair

from multihost_worker import _CheapForce
from torch_multihost_worker import CheapForce, cheap_streams
from torch_threads import single_torch_thread  # noqa: F401  (autouse)

T = torch.as_tensor
H, W, N = 144, 192, 8
TORCHRUN_VARS = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")
# the JAX whole-limb tests' configuration (tests/test_parallel.py)
JAX_CFG = scaled_ftp_config(H, W).replace(percentile_method="hist", unwrap_cg_iters=8,
                                          ecc_iters=20, inpaint_iters=8)
P2H = {"type": "hinge_saturating", "params": {"a": 2.08, "b": 4.2, "c": 0.0}}
FORCE = {"type": "growth", "params": {"a": 1.62, "b": 9.76}}
ALIGNMENT = ("dbg_global_shift", "dbg_ecc_warp", "dbg_ecc_rho", "dbg_ecc_iters")


def J(a):
    """A writable numpy copy (JAX hands out read-only buffers)."""
    return np.array(a)


def _rel(a, b):
    return np.abs(np.asarray(a, np.float64) - b) / np.maximum(np.abs(b), 1e-30)


# --------------------------------------------------------------- distributed (no group)
def test_initialize_multihost_single_process_noop(monkeypatch):
    """Without torchrun's environment the bring-up is a no-op; with it the
    intent is detected; malformed numbers are ignored (the JAX test with
    torchrun's names)."""
    assert not dist.is_initialized()
    for var in TORCHRUN_VARS:
        monkeypatch.delenv(var, raising=False)
    assert not tdist.is_multihost_env()
    assert tdist.initialize_multihost() is False
    assert not dist.is_initialized()

    monkeypatch.setenv("WORLD_SIZE", "4")
    assert tdist.is_multihost_env()
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert not tdist.is_multihost_env()
    monkeypatch.setenv("WORLD_SIZE", "four")
    assert not tdist.is_multihost_env()
    assert tdist._env_int("WORLD_SIZE") is None
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    assert tdist.is_multihost_env()
    # one process, one card: not jax.device_count()'s every device
    assert tdist.global_stream_count() == 1


def test_initialize_multihost_refuses_unknown_rank_and_card(monkeypatch):
    for var in TORCHRUN_VARS:
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(ValueError, match="RANK"):
        tdist.initialize_multihost("127.0.0.1:1", num_processes=2, device="cpu")
    with pytest.raises(ValueError, match="device"):
        tdist.initialize_multihost("127.0.0.1:1", 1, 0, device="meta")
    if not torch.cuda.is_available():
        # the card's group is NCCL or nothing: no gloo on the card
        with pytest.raises(RuntimeError, match="CUDA"):
            tdist.initialize_multihost("127.0.0.1:1", 1, 0)
        with pytest.raises(RuntimeError, match="CUDA"):
            tmesh.make_stream_mesh()
    assert not dist.is_initialized()


# --------------------------------------------------------------- hist route
@pytest.mark.parametrize("bins", [64, 128])
@pytest.mark.parametrize("refine", [0, 1, 2])
def test_hist_rows_bit_equal(bins, refine):
    """Three rows (a NaN speck, a partial mask, an empty mask) with one
    quantile each, and the same rows under a leading pair dimension."""
    rng = np.random.default_rng(100 + bins + refine)
    n = 3000
    x = rng.normal(size=(2, 3, n)).astype(np.float32)
    x[:, 0, 10:14] = np.nan
    x[:, 1] = np.round(x[:, 1] * 8.0)                     # ties
    m = np.ones((2, 3, n), bool)
    m[:, 1] = rng.random((2, n)) > 0.4
    m[:, 2] = False                                        # fallback
    qs = (99.5, 97.0, 50.0)
    got = tpct.masked_percentile_hist_rows(T(x), T(m), qs, bins=bins, refine=refine,
                                           fallback=-7.0).numpy()
    for p in range(2):
        want = J(jpct.masked_percentile_hist_rows(jnp.asarray(x[p]), jnp.asarray(m[p]), qs,
                                                  bins=bins, refine=refine, fallback=-7.0))
        assert got[p].tobytes() == want.tobytes(), (got[p], want)
    assert got[0, 2] == -7.0
    with pytest.raises(ValueError, match="quantiles"):
        tpct.masked_percentile_hist_rows(T(x[0]), T(m[0]), qs[:2])


def _crop_pair(jc):
    ref, de = synthetic_pair(480, 640, jc)
    gray = [J(jcolor.bgr_to_gray(jnp.asarray(f)))[143:379, 204:440] for f in (ref, de)]
    return np.stack(gray), circular_apodization(236, 236, 118, 118, 117, jc.apod_taper_px)


def test_hist_preprocess_matches():
    """The demod's preprocessing under ``hist`` (the 64-bin rows thresholds
    over each frame's image and gradient) against JAX's ``_preprocess``,
    frame by frame, on the slice's crop pair: within 1e-5 of the largest
    value (the blurs' summation order), as the sort route's test holds it."""
    jc = scaled_ftp_config(480, 640).replace(percentile_method="hist")
    tc = ftp_config_from_dict(dataclasses.asdict(jc))
    pair, apo = _crop_pair(jc)
    got = tdemod.preprocess(T(pair), T(apo), tc, DeviceConsts("cpu"))[0].numpy()
    for a, g in zip(got, pair):
        b = J(jdemod._preprocess(jnp.asarray(g), jnp.asarray(apo), jc)[0])
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5 * np.abs(b).max())


@pytest.mark.parametrize("order,iters,resigma", [(2, 6, 6), (2, 4, 2)])
def test_hist_irls_matches(monkeypatch, order, iters, resigma):
    """The non-fused IRLS under ``hist`` against JAX's
    ``_robust_polyfit2d_xla``: coefficients and surface within 1e-5 of
    their largest (the 6x6 normal equations' summation order).  Its median
    and MAD are refined once, as JAX's: twice moves the coefficients by no
    more than that order does, so the call itself is checked."""
    refines = []
    hist = tpoly.masked_percentile_hist

    def spy(*a, **k):
        refines.append(k["refine"])
        return hist(*a, **k)

    monkeypatch.setattr(tpoly, "masked_percentile_hist", spy)
    rng = np.random.default_rng(32)
    h, w = 70, 90
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    z = (0.4 + 2e-2 * xx - 3e-2 * yy + 1e-4 * xx * xx - 2e-4 * xx * yy + 3e-4 * yy * yy
         + rng.normal(scale=0.05, size=(h, w))).astype(np.float32)
    z[rng.random((h, w)) > 0.96] += 4.0
    z[10, 10] = np.nan
    m = (yy - 35) ** 2 + (xx - 45) ** 2 <= 33 ** 2
    jc, jfit = jpoly.robust_polyfit2d(jnp.asarray(z), jnp.asarray(m), order=order, iters=iters,
                                      resigma_iters=resigma, percentile_method="hist")
    c, fit = tpoly.robust_polyfit2d(T(z), T(m), order=order, iters=iters, resigma_iters=resigma,
                                    fused=False, percentile_method="hist")
    jc, jfit = J(jc), J(jfit)
    np.testing.assert_allclose(c.numpy(), jc, rtol=0, atol=1e-5 * np.abs(jc).max())
    np.testing.assert_allclose(fit.numpy(), jfit, rtol=0, atol=1e-5 * np.abs(jfit).max())
    assert refines == [1] * (2 * resigma)


# --------------------------------------------------------------- heads over the cheap force
@pytest.fixture(scope="module")
def meshes():
    """(JAX 8-device mesh, the port's world-1 gloo mesh); the group goes
    down with the module."""
    assert not dist.is_initialized()
    m = tmesh.make_stream_mesh(device="cpu")
    yield jmesh.make_stream_mesh(N), m
    dist.destroy_process_group()


def test_stream_mesh_world_one(meshes):
    _, m = meshes
    assert m.mesh_dim_names == ("stream",) and m.size() == 1 and m.device_type == "cpu"
    assert dist.get_backend() == "gloo" and tdist.global_stream_count() == 1
    assert tdist.initialize_multihost("127.0.0.1:1", 1, 0, device="cpu") is True   # no-op
    assert tmesh.make_stream_mesh(1, device="cpu").size() == 1
    with pytest.raises(ValueError, match="needs 2 processes"):
        tmesh.make_stream_mesh(2, device="cpu")
    x = np.arange(24).reshape(6, 4)
    assert torch.equal(tmesh.shard_batch(m, x), T(x))
    assert torch.equal(tmesh.shard_local_batch(m, x[:2]), T(x[:2]))
    if not torch.cuda.is_available():
        # the card's mesh is NCCL or nothing, a gloo group up or not
        with pytest.raises(RuntimeError, match="CUDA"):
            tmesh.make_stream_mesh()


def _jax_inputs(jm, *arrays):
    return [jmesh.shard_batch(jm, jnp.asarray(a)) for a in arrays]


def _assert_head_matches(out, jout, forces, gated=False):
    """``out`` (port) against ``jout`` (JAX): keys, shapes and dtypes the
    same; forces and sums within 1e-6 relative, the rest equal; the port's
    per-stream forces ``forces`` bit for bit.  ``gated`` (fractional motion
    gates): every output within 1e-6 of its largest magnitude, since XLA's
    CPU code contracts the gate's sum of squares into FMAs and multiplies by
    the float32 reciprocal of the ramp width (one float32 step apart)."""
    assert set(out) == set(jout)
    for k, v in out.items():
        want = J(jout[k])
        got = v.numpy()
        assert got.shape == want.shape and got.dtype == want.dtype == np.float32, k
        if gated:
            assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max(), k
        elif k in ("per_stream_force", "total_force_N", "contact_area_mm2"):
            assert _rel(got, want).max() <= 1e-6, (k, got, want)
        else:
            assert got.tobytes() == want.tobytes(), k
    assert torch.equal(out["per_stream_force"], forces)
    assert _rel(out["total_force_N"].numpy(), out["per_stream_force"].numpy().sum()) <= 1e-6


@pytest.mark.parametrize("map_stride", [1, 2])
@pytest.mark.parametrize("sign", [1, -1])
def test_whole_limb_step_matches_jax(meshes, map_stride, sign):
    """Positive heightmaps, and negative ones (the frames swapped), whose
    maps the sign auto-detect must still fill."""
    jm, m = meshes
    refs, defs = cheap_streams(N)
    if sign < 0:
        refs, defs = defs, refs
    jout = jmesh.whole_limb_step(_CheapForce(), jm, map_stride=map_stride)(
        *_jax_inputs(jm, refs, defs))
    out = tmesh.whole_limb_step(CheapForce(), m, map_stride=map_stride)(refs, defs)
    own = CheapForce().batched()(T(refs), T(defs))
    _assert_head_matches(out, jout, own["force_N"])
    limb = out["whole_limb_map_mm"]
    assert limb.shape == (N, H // map_stride, W // map_stride) and float(limb.max()) > 0.01
    # each stream's map is its own heightmap's contact depth, in stream order
    hm = own["height_map_mm"].numpy()[:, ::map_stride, ::map_stride]
    want = np.where(sign * hm > 0.01, sign * hm, 0.0).astype(np.float32)
    np.testing.assert_array_equal(limb.numpy(), want)


POSES = {
    # tests/test_parallel.py's 2x4 tiles, one patch each
    "tiles": ((288, 768), 2, np.array([[(k // 4) * 144, (k % 4) * 192] for k in range(N)])),
    # overlapping patches (the max-blend decides)
    "overlap": ((200, 300), 2, np.array([[0, 0], [20, 30], [40, 60], [56, 108],
                                        [10, 100], [50, 5], [30, 40], [5, 90]])),
    "overlap_stride1": ((200, 300), 1, np.array([[0, 0], [20, 30], [40, 60], [56, 108],
                                                [10, 100], [50, 5], [30, 40], [5, 90]])),
    # poses off the canvas on every side: clipped to keep each patch inside
    "clipped": ((288, 400), 2, np.array([[-50, -9], [500, 0], [0, 900], [300, 300],
                                        [-1, 250], [150, -300], [200, 208], [143, 207]])),
}


def _accel(case):
    accel = np.zeros((N, 3), np.float32)
    accel[7] = (30.0, 0.0, 0.0)          # moving fast: gated out
    accel[6] = (0.0, 11.0, 0.0)          # halfway up the ramp: gate 0.5
    if case != "tiles":
        accel[:6] = np.random.default_rng(7).normal(scale=7.0, size=(6, 3))
    return accel


def _max_blend(maps, gates, poses, canvas_hw, stride):
    """The canvas as a numpy max-blend of each map times its gate at its
    clipped pose."""
    ch, cw = canvas_hw[0] // stride, canvas_hw[1] // stride
    ph, pw = maps.shape[1:]
    canvas = np.zeros((ch, cw), np.float32)
    for mp, g, (y, x) in zip(maps, gates, poses):
        y, x = min(max(y // stride, 0), ch - ph), min(max(x // stride, 0), cw - pw)
        canvas[y:y + ph, x:x + pw] = np.maximum(canvas[y:y + ph, x:x + pw], mp * g)
    return canvas


@pytest.mark.parametrize("case", list(POSES))
def test_whole_limb_step_aux_matches_jax(meshes, case):
    jm, m = meshes
    canvas_hw, stride, pose = POSES[case]
    pose = pose.astype(np.int32)
    accel = _accel(case)
    refs, defs = cheap_streams(N)
    jaux = dict(zip(("pose_px", "accel_mss"), _jax_inputs(jm, pose, accel)))
    jout = jmesh.whole_limb_step_aux(_CheapForce(), jm, canvas_hw=canvas_hw,
                                     map_stride=stride)(*_jax_inputs(jm, refs, defs), jaux)
    out = tmesh.whole_limb_step_aux(CheapForce(), m, canvas_hw=canvas_hw, map_stride=stride)(
        refs, defs, {"pose_px": pose, "accel_mss": accel})
    gates = out["stream_gate"]
    own = CheapForce().batched()(T(refs), T(defs))
    _assert_head_matches(out, jout, own["force_N"] * gates, gated=case != "tiles")
    assert gates[6].item() == 0.5 and gates[7].item() == 0.0
    assert torch.equal(gates, tmesh.motion_gate(T(accel)))
    maps = tmesh.whole_limb_step(CheapForce(), m, map_stride=stride)(refs, defs)
    want = _max_blend(maps["whole_limb_map_mm"].numpy(), gates.numpy(), pose, canvas_hw, stride)
    np.testing.assert_array_equal(out["limb_canvas_mm"].numpy(), want)
    assert float(out["max_depth_mm"]) >= float(want.max()) > 0.01


def test_motion_gate_matches_jax():
    """Within 1e-6 of JAX's (the sum of squares: XLA's CPU code contracts it
    into FMAs), exactly 1, 0.5 and 0 on and off the ramp."""
    rng = np.random.default_rng(3)
    accel = np.concatenate([rng.normal(scale=10.0, size=(64, 3)),
                            [[0, 0, 0], [2, 0, 0], [0, 0, 20], [11, 0, 0], [0, 0, -40]]])
    accel = accel.astype(np.float32)
    for ok, cut in ((2.0, 20.0), (0.5, 9.0)):
        got = tmesh.motion_gate(T(accel), ok, cut).numpy()
        want = J(jmesh.motion_gate(jnp.asarray(accel), ok, cut))
        assert got.dtype == want.dtype and np.abs(got - want).max() <= 1e-6
    assert got.min() == 0.0 and got.max() == 1.0
    assert tmesh.motion_gate(T(accel[-5:])).tolist() == [1.0, 1.0, 0.0, 0.5, 0.0]


class _JaxCheapForce(_CheapForce):
    def batched(self):
        return jax.vmap(self._single)


def test_streaming_force_on_mesh_matches_jax(meshes):
    """``StreamingForce(mesh=...)`` over the cheap force: five batches of
    distinct frames against JAX's sharded ``StreamingForce`` (within 1e-6:
    the forces' and the ring mean's summation order; the flags equal), and
    bit for bit the port's own without a mesh, serialized or overlapped."""
    jm, m = meshes
    refs, _ = cheap_streams(N)
    seq = [cheap_streams(N, seed=s)[1] for s in range(1, 6)]
    sf = tstreaming.StreamingForce(CheapForce(), N, window=4, mesh=m)
    outs = [sf(refs, b) for b in seq]
    plain = tstreaming.StreamingForce(CheapForce(), N, window=4)
    over = tstreaming.StreamingForce(CheapForce(), N, window=4, mesh=m).run_overlapped(refs, seq)
    jsf = jstreaming.StreamingForce(_JaxCheapForce(), N, window=4, mesh=jm)
    for o, v, b in zip(outs, over, seq):
        p = plain(refs, b)
        j = jsf(*_jax_inputs(jm, refs, b))
        # JAX's step hands its state back sharded, which its own jit then
        # refuses: put it back replicated between calls
        jsf._state = jax.device_put(jsf._state, NamedSharding(jm, P()))
        assert set(o) == set(p) == set(j)
        for k in o:
            np.testing.assert_array_equal(o[k], p[k], err_msg=k)
            np.testing.assert_array_equal(o[k], v[k], err_msg=k)
            if o[k].dtype == bool:
                np.testing.assert_array_equal(o[k], np.asarray(j[k]), err_msg=k)
            else:
                np.testing.assert_allclose(o[k], np.asarray(j[k]), rtol=1e-6, atol=1e-7,
                                           err_msg=k)
    assert outs[-1]["in_contact"].any()
    with pytest.raises(ValueError, match="split"):
        tstreaming.StreamingForce(CheapForce(), N, mesh=_FakeMesh(3))


class _FakeMesh:
    """A mesh of ``n`` ranks, for the construction-time check only."""

    def __init__(self, n):
        self.n = n

    def size(self):
        return self.n


# --------------------------------------------------------------- the head over the real forward
class _JaxAlignedForce(jmesh.BatchedForce):
    """JAX's ``BatchedForce._single`` with the stream's alignment (global
    shift and ECC) beside its results."""

    def _single(self, ref_bgr, def_bgr):
        res = self.pipe._forward_impl(ref_bgr, def_bgr)
        height = res["height_map_mm_crop"]
        mm_per_px = self.grating_pitch_mm / jnp.maximum(res["est_period_px"], 1e-9)
        v, a, d = j_volume(height, jnp.isfinite(height), mm_per_px, self.depth_eps_mm)
        return {"force_N": jscalar.predict_force_from_volume(self.force_model, v),
                "volume_cm3": v, "contact_area_mm2": a, "max_depth_mm": d,
                "height_map_mm": height, **{k: res[k] for k in ALIGNMENT}}


class _Replay:
    """Per-stream results computed before, handed out by stream index (the
    JAX head's inputs are the indices)."""

    depth_eps_mm = 0.01

    def __init__(self, results):
        self.results = results

    def _single(self, idx, _):
        return {k: v[idx] for k, v in self.results.items()}


class _GivenAlignment:
    """The port's ``BatchedForce`` with each stream's global shift and ECC
    taken from JAX's run of that stream (the stream found by its reference
    frame); the port's own ECC is solved too, to hold against JAX's."""

    def __init__(self, bf, refs, jres):
        self.bf, self.refs, self.jres = bf, T(refs), jres
        self.depth_eps_mm = bf.depth_eps_mm
        self.own_ecc = []

    def _single(self, ref, de):
        k = next(i for i in range(len(self.refs)) if torch.equal(self.refs[i], ref))
        shift = T(self.jres["dbg_global_shift"][k])
        warp = tuple(T(self.jres[n][k]) for n in ALIGNMENT[1:])
        pipe = self.bf.pipe
        own, correlate = pipe._ecc, tftp_pipeline.phase_correlate
        pipe._ecc = lambda crop01: (self.own_ecc.append(own(crop01)), warp)[1]
        tftp_pipeline.phase_correlate = lambda a, b, win: (shift[0], shift[1], torch.zeros(()))
        try:
            return self.bf._single(ref, de)
        finally:
            del pipe._ecc
            tftp_pipeline.phase_correlate = correlate


@pytest.fixture(scope="module")
def real(meshes):
    """The JAX forward of 4 distinct streams (one compile), JAX's head over
    it on a 4-device mesh, and the port's head over its own forward, free
    and given JAX's alignment."""
    _, m = meshes
    tc = ftp_config_from_dict(dataclasses.asdict(JAX_CFG))
    pairs = [synthetic_pair(H, W, tc, dent_depth_rad=d, seed=s)
             for s, d in ((0, 0.8), (1, 0.5), (2, 1.1), (3, 0.65))]
    refs, defs = np.stack([p[0] for p in pairs]), np.stack([p[1] for p in pairs])
    jbf = _JaxAlignedForce(JaxFTPPipeline(JAX_CFG, P2H, debug_outputs=True), FORCE)
    jres = {k: J(v) for k, v in jax.jit(jbf.batched())(refs, defs).items()}
    j4 = jmesh.make_stream_mesh(4)
    idx = jmesh.shard_batch(j4, jnp.arange(4))
    jout = jmesh.whole_limb_step(_Replay({k: jnp.asarray(jres[k]) for k in (
        "force_N", "contact_area_mm2", "max_depth_mm", "height_map_mm")}), j4, map_stride=2)(
        idx, idx)
    bf = tmesh.BatchedForce(FTPPipeline(tc, P2H, device="cpu"), FORCE)
    kernels.reset_launches()
    free = tmesh.whole_limb_step(bf, m, map_stride=2)(refs, defs)
    assert all(v == 0 for v in kernels.LAUNCHES.values()), kernels.LAUNCHES
    aligned_force = _GivenAlignment(bf, refs, jres)
    aligned = tmesh.whole_limb_step(aligned_force, m, map_stride=2)(refs, defs)
    return dict(jres=jres, jout={k: J(v) for k, v in jout.items()}, free=free,
                aligned=aligned, own_ecc=aligned_force.own_ecc, bf=bf, refs=refs, defs=defs)


def test_real_forward_head_matches_jax(real):
    """Given JAX's alignment the per-stream forces, the summed force and
    area and the depth maximum land within 1% (the deploy contract), each
    stream's map maximum too, and no more than 1% of the map's pixels change
    contact state.  The port's own ECC from JAX's global shift lands within
    0.05 px of JAX's warp.  Free-running, the unconverged 20-iteration ECC
    (0.03 px apart on one stream) moves the force further: ``CHANGES.md``
    gives the gaps."""
    jout, got = real["jout"], {k: v.numpy() for k, v in real["aligned"].items()}
    assert set(got) == set(jout)
    for k in jout:
        assert got[k].shape == jout[k].shape and got[k].dtype == jout[k].dtype, k
    assert got["whole_limb_map_mm"].shape == (4, 36, 36)
    np.testing.assert_array_equal(jout["per_stream_force"], real["jres"]["force_N"])
    for k in ("per_stream_force", "total_force_N", "contact_area_mm2", "max_depth_mm"):
        assert _rel(got[k], jout[k]).max() <= 0.01, (k, got[k], jout[k])
    lm, jlm = got["whole_limb_map_mm"], jout["whole_limb_map_mm"]
    assert _rel(lm.max(axis=(1, 2)), jlm.max(axis=(1, 2))).max() <= 0.01
    assert np.mean((lm > 0) != (jlm > 0)) <= 0.01
    assert jlm.max() > 0.01
    for (warp, _, _), jw in zip(real["own_ecc"], real["jres"]["dbg_ecc_warp"]):
        assert np.abs(warp.numpy() - jw)[:, 2].max() < 0.05
    free = real["free"]
    assert _rel(free["total_force_N"].numpy(), free["per_stream_force"].numpy().sum()) <= 1e-6


def test_batched_force_sharded_is_the_local_batch(real, meshes):
    """``sharded(mesh)`` over the rank's block (all 4 streams at world 1):
    the batched forward's results, bit for bit, on the rank's device."""
    _, m = meshes
    bf, refs, defs = real["bf"], real["refs"], real["defs"]
    got = bf.sharded(m)(tmesh.shard_batch(m, refs), tmesh.shard_batch(m, defs))
    want = bf.batched()(refs, defs)
    assert set(got) == set(want)
    for k, v in got.items():
        assert v.device.type == "cpu" and v.shape[0] == 4, k
        assert torch.equal(v.nan_to_num(), want[k].nan_to_num()), k
    assert torch.equal(got["force_N"], real["free"]["per_stream_force"])
