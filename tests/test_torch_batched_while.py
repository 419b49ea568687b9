"""``jax.vmap`` of a forward with device loops on the CPU: the ECC and PCG
``lax.while_loop``s (``ecc_kernel.gn_loop``, ``ops/unwrap._wls_pcg_solve``)
and K4 (``ecc_kernel.gn_loop_euclidean``) take a stream axis, so every
configuration's stream batch is one batched forward.

- The plain versions at B = 1 and 3, each bit for bit its plane's own solve:
  the Gauss-Newton loop over the gather sampler's and the shear sampler's
  moments, euclidean and affine, K4's plain loop unseeded and seeded, and
  the PCG with the dense DCT, the FFT DCT (a 512x512 grid) and on the
  pooled grid.  The three planes stop at different trips (the ECC: one
  stops after two trips, one at ``max_iters``, one fails at its first;
  the PCG: one never starts), which shows a stopped plane frozen.
- At B = 2 against ``jax.vmap`` of the JAX function, within the
  single-plane tests' tolerances (``test_torch_device_loop.py``,
  ``test_torch_ecc_gn_loop.py``): ``ecc_align`` with the gather sampler;
  K4's loop against the JAX loop over ``gn_moments_euclidean`` in
  interpret mode (the JAX ``ecc_align`` takes that kernel where the backend
  is a TPU, which the test tells it it is), unseeded and seeded; the PCG,
  plain and pooled.
- K4's wrapper on a stack: one launch of every solve (recorded, not run).
- The whole forward at 144x192 over three seeded ``synthetic_pair``
  streams, with ``tests/test_parallel.py``'s budgets: the parity preset,
  the prealignment (the deploy preset with ``use_grating_band_prealign``)
  and the native-4K routes forced at this scale
  (``test_torch_slice_4kroutes.py``'s knobs): against each stream's single
  forward every mask, the reliable mask's labels, the ECC iterations and
  warps equal and every float within 1e-5 relative, the batched body under
  the host-read guard.  The parity batch against what the JAX
  ``BatchedForce.batched()`` computes, each stream through one
  ``jit(_single)`` compile: force, volume and area within 1%, the depth
  maximum within 2%.  The prealignment and the 4K routes are held to JAX
  stream by stream through their single forwards (``test_torch_knobs.py``,
  ``test_torch_slice_4kroutes.py``), which each stream equals bit for bit.
"""
import contextlib
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vistaf_tpu.ftp.pipeline import FTPPipeline as JaxFTPPipeline
from vistaf_tpu.ops import registration as jreg
from vistaf_tpu.ops import unwrap as jun
from vistaf_tpu.pallas import ecc_kernel as jk
from vistaf_tpu.parallel.mesh import BatchedForce as JaxBatchedForce
from vistaf_tpu.utils.synthetic import scaled_ftp_config

from vistaf_torch import kernels
from vistaf_torch.config import ftp_config_from_dict
from vistaf_torch.ftp.pipeline import FTPPipeline
from vistaf_torch.kernels import ecc_kernel
from vistaf_torch.ops import registration as treg
from vistaf_torch.ops import unwrap as tun
from vistaf_torch.ops.components import label
from vistaf_torch.ops.consts import DeviceConsts
from vistaf_torch.parallel.mesh import BatchedForce
from vistaf_torch.utils.synthetic import synthetic_pair

from torch_host_guard import PLAIN_VERSIONS, no_host_reads
from torch_threads import single_torch_thread  # noqa: F401  (autouse)

T = torch.as_tensor
H, W, STREAMS = 144, 192, 3
# tests/test_parallel.py's budgets of the vmapped parity step
BUDGETS = dict(ecc_iters=20, unwrap_cg_iters=8, inpaint_iters=8)
P2H = {"type": "hinge_saturating", "params": {"a": 2.08, "b": 4.2, "c": 0.0}}
FORCE = {"type": "growth", "params": {"a": 1.62, "b": 9.76}}
MAX_ITERS = 4
SEEDS = np.array([[0.0, 0.0, 0.0], [0.002, 0.5, -0.2], [0.0, 0.1, 0.1]], np.float32)


def _texture(dx=0.0, dy=0.0, th=0.0):
    h, w = 40, 56
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    x = np.cos(th) * xx - np.sin(th) * yy + dx
    y = np.sin(th) * xx + np.cos(th) * yy + dy
    return (0.5 + 0.3 * np.sin(x / 3.1) * np.cos(y / 4.3)
            + 0.1 * np.sin((x + y) / 5.7)).astype(np.float32)


def ecc_planes(b: int):
    """(templates, images, mask) of ``b`` solves: at b = 3 the image equal
    to its template (two trips: the step is exactly 0 and rho exactly 1),
    a rotated and shifted copy (``MAX_ITERS`` trips) and a flat template
    (cv2's StsNoConv at the first trip); at b = 1 the second alone."""
    base = _texture()
    planes = [(base, base), (base, _texture(0.9, -0.7, 0.01)),
              (np.full_like(base, 0.5), _texture(0.3, 0.2))]
    planes = planes if b == 3 else planes[1:2]
    h, w = base.shape
    yy, xx = np.mgrid[0:h, 0:w]
    mask = (yy - h / 2) ** 2 + (xx - w / 2) ** 2 <= (min(h, w) / 2 - 3) ** 2
    return (T(np.stack([p[0] for p in planes])), T(np.stack([p[1] for p in planes])),
            T(mask))


def _stride_grid(shape):
    sm = torch.zeros(shape)
    sm[::2, ::2] = 1.0
    return sm


def _solve(case: str, tm, im, mask, seeds):
    """One ECC solve, or a stack of them, on ``case``'s route: (warp or p,
    rho, iterations[, failed])."""
    kw = dict(max_iters=MAX_ITERS, eps=1e-7)
    if case.startswith("gather_"):
        return treg.ecc_align(tm, im, mask, mode=case[7:], sampler="gather", loop_kernel=False,
                              **kw)
    if case == "shear_affine":
        return treg.ecc_align(tm, im, mask, mode="affine", sampler="shear", stride=2,
                              loop_kernel=False, **kw)
    S, Tc = treg.ecc_prepare(tm, im, mask)
    sm = _stride_grid(Tc.shape[-2:])
    p0 = T(seeds) if case == "k4_seeded" else torch.zeros(*Tc.shape[:-2], 3)
    if case == "shear_euclidean":      # the loop over the plain shear moments
        return ecc_kernel.gn_loop(lambda q: treg._plain_moments(S, Tc, sm, q, 4), p0,
                                  kw["max_iters"], kw["eps"], 0)
    return ecc_kernel.gn_loop_euclidean(S, Tc, sm, p0, 4, **kw)


ECC_CASES = ["gather_euclidean", "gather_affine", "shear_euclidean", "shear_affine", "k4",
             "k4_seeded"]


def jax_pair():
    """(templates, images, mask) of the two solves held to ``jax.vmap``: the
    template at two warps."""
    tm, im, mask = ecc_planes(1)
    return (tm.expand(2, *tm.shape[-2:]).contiguous(),
            torch.cat([im, T(_texture(-0.6, 0.4, -0.005))[None]]), mask)


def _equal(got, want):
    return all(torch.equal(g.nan_to_num(7.0) if g.is_floating_point() else g,
                           w.nan_to_num(7.0) if w.is_floating_point() else w)
               for g, w in zip(got, want))


@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("case", ECC_CASES)
def test_ecc_loop_stack_is_each_planes_own_solve(case, b):
    """A stack of B solves through the loop running while any is live, bit
    for bit each plane's own solve; at B = 3 the planes stop after 2,
    ``MAX_ITERS`` and 1 trips, the last failed (NaN rho)."""
    tm, im, mask = ecc_planes(b)
    seeds = SEEDS[:b] if b == 3 else SEEDS[1:2]
    got = _solve(case, tm, im, mask, seeds)
    one = [_solve(case, tm[i], im[i], mask, seeds[i]) for i in range(b)]
    want = [torch.stack(v) for v in zip(*one)]
    assert got[0].shape[0] == b and _equal(got, want), case
    it = got[2]
    if b == 3:
        assert it.tolist() == [2, MAX_ITERS, 1], it
        rho = got[1]
        assert torch.isnan(rho[2]) or bool(got[3][2]), rho


def pcg_planes(b: int, n=(40, 56)):
    """(wrapped, mask) of ``b`` unwraps on an ``n`` grid: at b = 3 a plane
    of zero phase (its PCG never starts), a smooth field with a ramp and
    the same under a smaller disk."""
    h, w = n
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    field = (0.004 * (40.0 / h) * ((xx - w / 3) ** 2 + (yy - h / 2) ** 2)
             + 0.09 * xx * (40.0 / h)).astype(np.float32)
    disk = (yy - h / 2) ** 2 + (xx - w / 2) ** 2 <= (min(h, w) / 2 - 3) ** 2
    small = (yy - h / 2) ** 2 + (xx - w / 2) ** 2 <= (min(h, w) / 3) ** 2
    planes = [(np.zeros_like(field), disk), (field, disk), (1.3 * field, small)]
    planes = planes if b == 3 else planes[1:2]
    wr = np.stack([np.angle(np.exp(1j * f)).astype(np.float32) for f, _ in planes])
    return T(wr), T(np.stack([m for _, m in planes]))


PCG_CASES = {"dense": dict(downsample=1), "pooled": dict(downsample=2),
             "fft_dct": dict(downsample=1, n=(512, 512))}


@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("case", sorted(PCG_CASES))
def test_pcg_stack_is_each_planes_own_solve(case, b, monkeypatch):
    """The PCG over a stack, running while any plane is live, bit for bit
    each plane's own unwrap; at B = 3 the zero plane's trip count stays 0
    while the others run to ``cg_iters``."""
    kw = dict(PCG_CASES[case])
    wr, m = pcg_planes(b, kw.pop("n", (40, 56)))
    assert tun.dense_dct_solve(wr.shape[-2:]) == (case != "fft_dct")
    consts = DeviceConsts("cpu")
    trips = []
    real = tun.device_while

    def spy(cond, body, state, **kw):
        real(cond, body, state, **kw)
        trips.append(state[-1].clone())
    monkeypatch.setattr(tun, "device_while", spy)
    got = tun.unwrap_wls(wr, m, consts, cg_iters=8, **kw)
    want = torch.stack([tun.unwrap_wls(wr[i], m[i], consts, cg_iters=8, **kw)
                        for i in range(b)])
    assert got.shape == want.shape and torch.equal(got.nan_to_num(7.0), want.nan_to_num(7.0))
    assert torch.equal(trips[0], torch.stack(trips[1:]))
    if b == 3:
        assert trips[0].tolist() == [0, 8, 8], trips[0]


def test_ecc_gather_stack_matches_jax_vmap():
    """B = 2 against ``jax.vmap`` of the JAX ``ecc_align`` with the gather
    sampler: the trip counts equal, the translations within 1e-4 px, the
    linear part within 5e-5 and rho within 2e-6 (the single-plane gates of
    ``test_torch_device_loop.py``)."""
    tm, im, mask = jax_pair()
    kw = dict(mode="euclidean", sampler="gather", max_iters=100, eps=1e-5)
    jw, jrho, jit = jax.vmap(lambda a, b: jreg.ecc_align(a, b, jnp.asarray(mask.numpy()),
                                                         **kw))(jnp.asarray(tm.numpy()),
                                                                jnp.asarray(im.numpy()))
    w, rho, it = treg.ecc_align(tm, im, mask, loop_kernel=False, **kw)
    assert it.tolist() == np.asarray(jit).tolist()
    np.testing.assert_allclose(w.numpy()[:, :, 2], np.asarray(jw)[:, :, 2], rtol=0, atol=1e-4)
    np.testing.assert_allclose(w.numpy()[:, :, :2], np.asarray(jw)[:, :, :2], rtol=0, atol=5e-5)
    np.testing.assert_allclose(rho.numpy(), np.asarray(jrho), rtol=0, atol=2e-6)


@pytest.mark.parametrize("seeded", [False, True])
def test_k4_stack_matches_jax_vmap_of_the_interpreted_kernel(seeded, monkeypatch):
    """B = 2 against ``jax.vmap`` of the JAX ``ecc_align`` whose moments are
    ``gn_moments_euclidean`` in interpret mode (the 4-stream pipeline's
    vmapped ``pallas_call``): gates 0.05 px on the translations, 5e-5 rad on
    the angle and 1e-4 on rho (``test_torch_ecc_gn_loop.py``)."""
    tm, im, mask = jax_pair()
    seeds = SEEDS[1:] if seeded else np.zeros((2, 3), np.float32)
    calls = []
    interpret = functools.partial(jk.gn_moments_euclidean, interpret=True)
    monkeypatch.setattr(jk, "gn_moments_euclidean",
                        lambda *a, **k: calls.append(1) or interpret(*a, **k))
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    jw, jrho, _ = jax.vmap(lambda a, b, p: jreg.ecc_align(
        a, b, jnp.asarray(mask.numpy()), mode="euclidean", sampler="shear", stride=2,
        shear_k=4, loop_kernel=False, max_iters=300, eps=1e-7,
        p_init=p if seeded else None))(jnp.asarray(tm.numpy()), jnp.asarray(im.numpy()),
                                       jnp.asarray(seeds))
    monkeypatch.undo()
    assert calls, "the JAX loop did not take the kernel"
    S, Tc = treg.ecc_prepare(tm, im, mask)
    p, rho, it, failed = ecc_kernel.gn_loop_euclidean(S, Tc, _stride_grid(Tc.shape[-2:]),
                                                      T(seeds), 4, 300, 1e-7, 0)
    jw = np.asarray(jw)
    assert not failed.any() and (it > 0).all()
    np.testing.assert_allclose(rho.numpy(), np.asarray(jrho), rtol=0, atol=1e-4)
    np.testing.assert_allclose(p[:, 1:].numpy(), jw[:, :, 2], rtol=0, atol=0.05)
    np.testing.assert_allclose(p[:, 0].numpy(), np.arctan2(jw[:, 1, 0], jw[:, 0, 0]), rtol=0,
                               atol=5e-5)


@pytest.mark.parametrize("downsample", [1, 2], ids=["plain", "pooled"])
def test_pcg_stack_matches_jax_vmap(downsample):
    """B = 2 against ``jax.vmap`` of the JAX ``unwrap_wls``: the same NaNs and
    every masked pixel within 1e-4 rad (``test_torch_device_loop.py``)."""
    wr, m = pcg_planes(3)
    wr, m = wr[1:], m[1:]
    want = np.asarray(jax.vmap(lambda a, b: jun.unwrap_wls(a, b, cg_iters=16,
                                                           downsample=downsample))(
        jnp.asarray(wr.numpy()), jnp.asarray(m.numpy())))
    got = tun.unwrap_wls(wr, m, DeviceConsts("cpu"), cg_iters=16,
                         downsample=downsample).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got[m.numpy()], want[m.numpy()], rtol=0, atol=1e-4)


def test_k4_stack_is_one_launch(monkeypatch):
    """K4's wrapper on a stack of solves: one launch of the stack kernel, at
    the stack's inputs, with ``n`` the solves and a scratch of two exchange
    buffers for a wave's solves (the launches replaced by a recorder, the
    tensors on the CPU standing in for the card's)."""
    tm, im, mask = ecc_planes(3)
    S, Tc = treg.ecc_prepare(tm, im, mask)
    calls = []

    class Lib:
        @staticmethod
        def vt_gn_loop_stack_slots(n, h, w, K, nr, nc):
            return 2

    monkeypatch.setattr(kernels, "route", lambda t: "cuda")
    monkeypatch.setattr(kernels, "check_cuda", lambda *a: None)
    monkeypatch.setattr(kernels, "library", lambda: Lib)
    monkeypatch.setattr(kernels, "launch", lambda *a: calls.append(a))
    monkeypatch.setattr(ecc_kernel, "_sm_count", lambda index: 132)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    p, rho, it, failed = ecc_kernel.gn_loop_euclidean(S, Tc, _stride_grid(Tc.shape[-2:]),
                                                      torch.zeros(3, 3), 4, 30, 1e-7, 0)
    assert p.shape == (3, 3) and rho.shape == it.shape == failed.shape == (3,)
    (c,) = calls
    nr, nc = ecc_kernel.tile_plan(40, 56, 4, 132)
    assert c[:3] == ("vt_gn_loop_euclidean_stack", "gn_moments_euclidean", S.device)
    assert c[3] == S.data_ptr() and c[9:15] == (3, 40, 56, 4, nr, nc)
    assert c[8] - c[7] == 4 * 6 * 3                       # the outputs, then the scratch


# ----------------------------------------------------------------------
# the whole forward
# ----------------------------------------------------------------------
def _configs():
    base = scaled_ftp_config(H, W)
    return {"parity": base.replace(**BUDGETS),
            "prealign": base.deploy().replace(use_grating_band_prealign=True, **BUDGETS),
            "4k_routes": base.deploy().replace(ecc_downsample_min_px=0,
                                               unwrap_downsample_min_px=0,
                                               polyfit_kernel=False, **BUDGETS)}


@pytest.fixture(scope="module")
def frames():
    cfg = ftp_config_from_dict(dataclasses.asdict(_configs()["parity"]))
    pairs = [synthetic_pair(H, W, cfg, dent_depth_rad=d, seed=s)
             for s, d in ((0, 0.8), (1, 0.5), (2, 1.1))]
    return np.stack([p[0] for p in pairs]), np.stack([p[1] for p in pairs])


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    both = torch.isfinite(a) & torch.isfinite(b)
    assert torch.equal(both, torch.isfinite(a)) and torch.equal(both, torch.isfinite(b))
    scale = torch.clamp(b[both].abs().max(), min=1e-30) if both.any() else 1.0
    return float(((a - b).abs()[both] / scale).max()) if both.any() else 0.0


@pytest.mark.parametrize("name", ["parity", "prealign", "4k_routes"])
def test_batched_forward_matches_each_streams_forward(name, frames, monkeypatch):
    """One forward over the (3, H, W, 3) stacks, under the host-read guard
    (what the batch graph captures), against each stream's single forward: every mask, the reliable mask's
    labels, the ECC iterations and warps equal, every float within 1e-5
    relative (of its map's largest magnitude)."""
    cfg = ftp_config_from_dict(dataclasses.asdict(_configs()[name]))
    pipe = FTPPipeline(cfg, P2H, debug_outputs=True, device="cpu")
    refs, defs = T(frames[0]), T(frames[1])
    one = [pipe.forward_eager(refs[b], defs[b]) for b in range(STREAMS)]
    kernels.reset_launches()
    with no_host_reads(monkeypatch, PLAIN_VERSIONS):     # the constants built above
        got = pipe.forward_eager(refs, defs)
    assert all(v == 0 for v in kernels.LAUNCHES.values()), kernels.LAUNCHES
    for k, v in got.items():
        want = torch.stack([o[k] for o in one])
        assert v.shape == want.shape and v.dtype == want.dtype, k
        if v.dtype == torch.bool or k in ("dbg_ecc_iters", "dbg_ecc_warp"):
            assert torch.equal(v, want), k
        else:
            assert _rel(v, want) <= 1e-5, k
    assert torch.equal(label(got["reliable_crop"]),
                       torch.stack([label(o["reliable_crop"]) for o in one]))


def test_parity_batch_matches_jax_batched(frames):
    """``BatchedForce.batched()`` under the parity preset against the JAX
    ``BatchedForce``'s ``vmap(_single)``, each stream through the JAX
    ``_single`` (one ``jit`` compile): force, volume and area within 1% (the
    parity gate of ``torch_slice_gates``), the depth maximum within 2%."""
    jcfg = _configs()["parity"]
    single = jax.jit(JaxBatchedForce(JaxFTPPipeline(jcfg, P2H), FORCE)._single)
    one = [single(frames[0][b], frames[1][b]) for b in range(STREAMS)]
    jout = {k: np.stack([np.array(o[k]) for o in one]) for k in one[0]}
    cfg = ftp_config_from_dict(dataclasses.asdict(jcfg))
    out = BatchedForce(FTPPipeline(cfg, P2H, device="cpu"), FORCE).batched()(*frames)
    assert set(out) == set(jout)
    for k, rtol in (("force_N", 0.01), ("volume_cm3", 0.01), ("contact_area_mm2", 0.01),
                    ("max_depth_mm", 0.02)):
        assert out[k].shape == (STREAMS,) and out[k].dtype == torch.float32, k
        np.testing.assert_allclose(out[k].numpy(), jout[k], rtol=rtol, err_msg=k)
    assert out["height_map_mm"].shape == jout["height_map_mm"].shape
    assert (out["force_N"] > 0).all()
