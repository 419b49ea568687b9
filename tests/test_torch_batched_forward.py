"""The batched force forward (the JAX package's ``jax.vmap`` of its force
forward: every op once over a leading stream axis, every kernel once with
the streams in its grid) on the CPU.

- The four kernels that took a stream axis: the batched plain versions of
  K5 (``ecc_loop_euclidean``), K6 (``unwrap_wls``), K7
  (``robust_polyfit2d_coef``) and the labels at B = 1 and 3, bit for bit
  each plane's own plain version; at B = 2 against ``jax.vmap`` of the JAX
  function (the Pallas kernels in interpret mode, as the JAX kernel tests
  run them; the labels' XLA loop) within the single-plane tests'
  tolerances (``test_torch_kernels.py``, ``test_torch_kernels_deploy.py``;
  the labels bit for bit); K6's wrapper on a stack of more planes than one
  launch takes, its launches recorded: ``MAX_PLANES`` planes a launch.
- The whole forward at 144x192 under the scaled deploy preset, three
  seeded ``synthetic_pair`` streams: against the per-stream route (each
  stream's single forward) masks, labels (the reliable mask's components)
  and ECC iterations equal and the floats within 1e-5 relative; against
  what the JAX ``BatchedForce.batched()`` computes (``jit(vmap(_single))``:
  each stream's ``_single``, here one ``jit(_single)`` compile run once a
  stream, which compiles in about half the time of the vmapped forward)
  within ``test_torch_multimodal.py``'s deploy-contract tolerances; the
  batched body under the host-read guard.
- Every configuration is batched: the parity preset (the gather ECC's and
  the PCG's WHILE nodes), the prealignment (K4), a PCG unwrap, K4's crop
  ECC and the deploy preset's knobs each take a stack in one forward.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vistaf_tpu.ops import components as jcomp
from vistaf_tpu.pallas.ecc_loop_kernel import ecc_loop_euclidean as jax_ecc_loop
from vistaf_tpu.pallas.polyfit_kernel import robust_polyfit2d_pallas
from vistaf_tpu.pallas import unwrap_kernel as j_unwrap
from vistaf_tpu.ftp.pipeline import FTPPipeline as JaxFTPPipeline
from vistaf_tpu.parallel.mesh import BatchedForce as JaxBatchedForce
from vistaf_tpu.utils.synthetic import scaled_ftp_config

from vistaf_torch import kernels
from vistaf_torch.config import ftp_config_from_dict
from vistaf_torch.ftp.pipeline import FTPPipeline
from vistaf_torch.kernels import ccl_kernel, ecc_loop_kernel, polyfit_kernel, unwrap_kernel
from vistaf_torch.ops.components import label
from vistaf_torch.ops.consts import DeviceConsts
from vistaf_torch.ops.registration import ecc_prepare
from vistaf_torch.parallel.mesh import BatchedForce
from vistaf_torch.utils.synthetic import synthetic_pair

from torch_host_guard import PLAIN_VERSIONS, no_host_reads
from torch_threads import single_torch_thread  # noqa: F401  (autouse)

T = torch.as_tensor
H, W, STREAMS = 144, 192, 3
JAX_CFG = scaled_ftp_config(H, W).deploy()
P2H = {"type": "hinge_saturating", "params": {"a": 2.08, "b": 4.2, "c": 0.0}}
FORCE = {"type": "growth", "params": {"a": 1.62, "b": 9.76}}
ECC_KW = dict(K=4, max_iters=40, eps=1e-7, stall_patience=0)


def _planes(kind: str, b: int, seed: int = 0):
    """``b`` seeded planes for one kernel: (S, T) ECC stacks, (z, mask)
    polyfit scenes, (wrapped, mask) phases or masks."""
    rng = np.random.default_rng(seed)
    h, w = 40, 56
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    if kind == "labels":
        return rng.random((b, 23, 31)) > 0.45
    if kind == "ecc":
        shift = rng.uniform(-0.8, 0.8, size=(b, 2)).astype(np.float32)
        tmpl = np.stack([0.5 + 0.3 * np.sin(xx / 3.1) * np.cos(yy / 4.3)] * b)
        img = np.stack([0.5 + 0.3 * np.sin((xx - sx) / 3.1) * np.cos((yy - sy) / 4.3)
                        for sx, sy in shift])
        mask = (yy - h / 2) ** 2 + (xx - w / 2) ** 2 <= (min(h, w) / 2 - 4) ** 2
        S, Tc = ecc_prepare(T(tmpl.astype(np.float32)), T(img.astype(np.float32)), T(mask))
        return S, Tc
    if kind == "polyfit":
        xn, yn = (xx - (w - 1) / 2) / ((w - 1) / 2), (yy - (h - 1) / 2) / ((h - 1) / 2)
        # test_torch_kernels.py's quadratic, its constant stepped a plane
        z = np.stack([0.8 * xn - 0.5 * yn + (0.2 + 0.1 * k) + 0.6 * xn * xn - 0.3 * xn * yn
                      + 0.1 * yn * yn + 0.02 * rng.standard_normal((h, w)) for k in range(b)])
        z = np.where(rng.random(z.shape) < 0.1, z + 3.0, z).astype(np.float32)
        return z, rng.random((b, h, w)) > 0.15
    base = np.stack([(0.004 * (k + 1)) * ((xx - 20) ** 2 + (yy - 18) ** 2) + 0.09 * xx
                     for k in range(b)])
    mask = np.broadcast_to((yy - h / 2) ** 2 + (xx - w / 2) ** 2 <= (min(h, w) / 2 - 3) ** 2,
                           base.shape).copy()
    return np.angle(np.exp(1j * base)).astype(np.float32), mask


def _batched_and_planes(kind: str, b: int):
    """(the batched plain version, each plane's plain version stacked)."""
    if kind == "labels":
        m = T(_planes(kind, b))
        return (ccl_kernel.label_components(m),
                torch.stack([ccl_kernel.label_components_plain(p) for p in m]))
    if kind == "ecc":
        S, Tc = _planes(kind, b)
        sm = torch.ones(Tc.shape[-2:])
        got = ecc_loop_kernel.ecc_loop_euclidean(S, Tc, sm, **ECC_KW)
        one = [ecc_loop_kernel.ecc_loop_euclidean_plain(S[i], Tc[i], sm, **ECC_KW)
               for i in range(b)]
        return torch.cat([got[0], torch.stack(got[1:], dim=-1).float()], dim=-1), \
            torch.stack([torch.cat([o[0], torch.stack(o[1:]).float()]) for o in one])
    if kind == "polyfit":
        z, m = map(T, _planes(kind, b))
        kw = dict(order=2, iters=4, resigma_iters=2)
        return (polyfit_kernel.robust_polyfit2d_coef(z, m, **kw),
                torch.stack([polyfit_kernel.robust_polyfit2d_coef_plain(z[i], m[i], **kw)
                             for i in range(b)]))
    wr, m = map(T, _planes(kind, b))
    consts = DeviceConsts("cpu")
    return (unwrap_kernel.unwrap_wls(wr, m, consts, cg_iters=16),
            torch.stack([unwrap_kernel.unwrap_wls_plain(wr[i], m[i], consts, cg_iters=16)
                         for i in range(b)]))


@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("kind", ["labels", "ecc", "polyfit", "unwrap"])
def test_batched_plain_version_is_each_planes_own(kind, b):
    """A stack through a wrapper's CPU route is each plane's plain version,
    bit for bit, with the stream axis leading."""
    kernels.reset_launches()
    got, want = _batched_and_planes(kind, b)
    assert all(v == 0 for v in kernels.LAUNCHES.values()), kernels.LAUNCHES
    assert got.shape == want.shape and got.shape[0] == b
    assert torch.equal(got.nan_to_num(7.0), want.nan_to_num(7.0))


@pytest.mark.parametrize("kind", ["labels", "ecc", "polyfit", "unwrap"])
def test_batched_plain_version_matches_jax_vmap(kind):
    """At B = 2 against ``jax.vmap`` of the JAX function: the labels bit for
    bit; K5 rho 1e-4, theta 5e-5 rad, translations 5e-3 px and ``failed``
    equal; K7 coefficients rtol 1e-4; K6 the same NaNs and at least 99.9%
    of the pixels within 1e-3 (the single-plane tests' bounds)."""
    if kind == "labels":
        m = _planes(kind, 2)
        np.testing.assert_array_equal(label(T(m)).numpy(),
                                      np.asarray(jax.vmap(jcomp.label)(jnp.asarray(m))))
        return
    if kind == "ecc":
        S, Tc = _planes(kind, 2)
        sm = np.ones(Tc.shape[-2:], np.float32)
        jp, jrho, jit, jfail = jax.vmap(lambda s, t: jax_ecc_loop(
            s, t, jnp.asarray(sm), interpret=True, **ECC_KW))(jnp.asarray(S.numpy()),
                                                              jnp.asarray(Tc.numpy()))
        p, rho, it, failed = ecc_loop_kernel.ecc_loop_euclidean(S, Tc, T(sm), **ECC_KW)
        assert p.shape == (2, 3) and rho.shape == it.shape == failed.shape == (2,)
        np.testing.assert_array_equal(failed.numpy(), np.asarray(jfail))
        assert np.abs(rho.numpy() - np.asarray(jrho)).max() < 1e-4
        assert np.abs(p[:, 0].numpy() - np.asarray(jp)[:, 0]).max() < 5e-5
        assert np.abs(p[:, 1:].numpy() - np.asarray(jp)[:, 1:]).max() < 5e-3
        return
    if kind == "polyfit":
        z, m = _planes(kind, 2)
        gold = jax.vmap(lambda a, b: robust_polyfit2d_pallas(
            a, b, order=2, iters=4, resigma_iters=2, interpret=True)[0])(
            jnp.asarray(z), jnp.asarray(m))
        ours = polyfit_kernel.robust_polyfit2d_coef(T(z), T(m), order=2, iters=4,
                                                    resigma_iters=2)
        np.testing.assert_allclose(ours.numpy(), np.asarray(gold), rtol=1e-4, atol=0)
        return
    wr, m = _planes(kind, 2)
    gold = np.asarray(jax.vmap(lambda a, b: j_unwrap.unwrap_wls_pallas(
        a, b, cg_iters=16, tol=1e-8, interpret=True))(jnp.asarray(wr), jnp.asarray(m)))
    ours = unwrap_kernel.unwrap_wls(T(wr), T(m), DeviceConsts("cpu"), cg_iters=16).numpy()
    np.testing.assert_array_equal(np.isnan(ours), ~m)
    np.testing.assert_array_equal(np.isnan(ours), np.isnan(gold))
    assert (np.abs(ours[m] - gold[m]) < 1e-3).mean() >= 0.999


def test_unwrap_launches_a_large_stack_sixteen_planes_at_a_time(monkeypatch):
    """K6's wrapper on a stack of more planes than one launch takes
    (``MAX_PLANES``): consecutive launches of up to ``MAX_PLANES`` planes,
    each at its first plane's input, mask and output, with one scratch
    buffer sized for a launch (the launches replaced by a recorder, the
    tensors on the CPU standing in for the card's)."""
    b = 2 * unwrap_kernel.MAX_PLANES + 3
    wr, m = map(T, _planes("unwrap", b))
    h, w = wr.shape[-2:]
    calls = []

    class Lib:
        @staticmethod
        def vt_unwrap_work_elems(hp, wp):
            return 1000

    monkeypatch.setattr(kernels, "route", lambda t: "cuda")
    monkeypatch.setattr(kernels, "check_cuda", lambda *a: None)
    monkeypatch.setattr(kernels, "library", lambda: Lib)
    monkeypatch.setattr(kernels, "launch", lambda *a: calls.append(a))
    out = unwrap_kernel.unwrap_wls(wr, m, DeviceConsts("cpu"), cg_iters=16)
    assert out.shape == wr.shape
    firsts = range(0, b, unwrap_kernel.MAX_PLANES)
    assert [c[12] for c in calls] == [min(unwrap_kernel.MAX_PLANES, b - p) for p in firsts]
    for c, p in zip(calls, firsts):
        assert c[:2] == ("vt_unwrap_wls", "unwrap_wls")
        assert c[3] == wr.data_ptr() + 4 * p * h * w              # wrapped
        assert c[9] - calls[0][9] == p * h * w                   # mask (bytes)
        assert c[10] == out.data_ptr() + 4 * p * h * w           # out
        assert c[11] == calls[0][11]                             # one scratch


# ----------------------------------------------------------------------
# the whole forward
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def streams():
    cfg = ftp_config_from_dict(dataclasses.asdict(JAX_CFG))
    pairs = [synthetic_pair(H, W, cfg, dent_depth_rad=d, seed=s)
             for s, d in ((0, 0.8), (1, 0.5), (2, 1.1))]
    refs, defs = np.stack([p[0] for p in pairs]), np.stack([p[1] for p in pairs])
    return dict(cfg=cfg, refs=refs, defs=defs,
                pipe=FTPPipeline(cfg, P2H, debug_outputs=True, device="cpu"))


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    both = torch.isfinite(a) & torch.isfinite(b)
    assert torch.equal(both, torch.isfinite(a)) and torch.equal(both, torch.isfinite(b))
    scale = torch.clamp(b[both].abs().max(), min=1e-30) if both.any() else 1.0
    return float(((a - b).abs()[both] / scale).max()) if both.any() else 0.0


def test_batched_forward_matches_the_per_stream_route(streams):
    """One forward over the (3, H, W, 3) stacks against each stream's single
    forward: every mask, the reliable mask's labels and the ECC iterations
    equal, every float within 1e-5 relative (of its map's largest
    magnitude); and ``BatchedForce``'s batched forward alike its
    per-stream reference."""
    pipe = streams["pipe"]
    refs, defs = T(streams["refs"]), T(streams["defs"])
    kernels.reset_launches()
    got = pipe.forward_eager(refs, defs)
    assert all(v == 0 for v in kernels.LAUNCHES.values()), kernels.LAUNCHES
    one = [pipe.forward_eager(refs[b], defs[b]) for b in range(STREAMS)]
    for k, v in got.items():
        want = torch.stack([o[k] for o in one])
        assert v.shape == want.shape and v.dtype == want.dtype, k
        if v.dtype == torch.bool or k == "dbg_ecc_iters":
            assert torch.equal(v, want), k
        else:
            assert _rel(v, want) <= 1e-5, k
    assert torch.equal(label(got["reliable_crop"]),
                       torch.stack([label(o["reliable_crop"]) for o in one]))
    bf = BatchedForce(FTPPipeline(streams["cfg"], P2H, device="cpu"), FORCE)
    a, b = bf.batched_eager(refs, defs), bf.per_stream_eager(refs, defs)
    assert set(a) == set(b)
    for k in a:
        assert a[k].shape == b[k].shape and _rel(a[k], b[k]) <= 1e-5, k


def test_batched_forward_matches_jax_batched(streams):
    """``BatchedForce.batched()`` against the JAX ``BatchedForce``'s
    ``vmap(_single)`` semantics, each stream through the JAX ``_single``
    (one ``jit`` compile), on the same streams, within the deploy
    contract's tolerances of ``test_torch_multimodal.py``'s
    ``BatchedForce`` test: force, volume and area 1%, the depth maximum 2%."""
    single = jax.jit(JaxBatchedForce(JaxFTPPipeline(JAX_CFG, P2H), FORCE)._single)
    one = [single(streams["refs"][b], streams["defs"][b]) for b in range(STREAMS)]
    jout = {k: np.stack([np.array(o[k]) for o in one]) for k in one[0]}
    out = BatchedForce(FTPPipeline(streams["cfg"], P2H, device="cpu"),
                       FORCE).batched()(streams["refs"], streams["defs"])
    assert set(out) == set(jout)
    for k, rtol in (("force_N", 0.01), ("volume_cm3", 0.01), ("contact_area_mm2", 0.01),
                    ("max_depth_mm", 0.02)):
        assert out[k].shape == (STREAMS,) and out[k].dtype == torch.float32, k
        np.testing.assert_allclose(out[k].numpy(), jout[k], rtol=rtol, err_msg=k)
    assert out["height_map_mm"].shape == jout["height_map_mm"].shape
    assert (out["force_N"] > 0).all()


def test_batched_body_reads_nothing_on_the_host(streams, monkeypatch):
    """``BatchedForce.batched_eager`` on the batched route (what the batch
    graph captures on the card) under the host-read guard, the kernels'
    plain versions exempt: the same bits as unguarded."""
    bf = BatchedForce(FTPPipeline(streams["cfg"], P2H, device="cpu"), FORCE)
    refs, defs = T(streams["refs"]), T(streams["defs"])
    want = bf.batched_eager(refs, defs)
    with no_host_reads(monkeypatch, PLAIN_VERSIONS):
        got = bf.batched_eager(refs, defs)
    for k in want:
        assert torch.equal(got[k].nan_to_num(7.0), want[k].nan_to_num(7.0)), k


def test_route_is_by_configuration_and_shape(streams):
    """Every configuration is batched: the parity preset (the gather ECC's
    and the PCG's WHILE nodes), the prealignment (K4), a PCG unwrap, K4's
    crop ECC and the deploy preset's knobs each run a stack as one forward
    (``BatchedForce.batched_eager``), each stream's force its single
    forward's; a second stream axis raises."""
    cfg = streams["cfg"]
    configs = {"parity": ftp_config_from_dict(dataclasses.asdict(scaled_ftp_config(H, W))),
               "prealign": cfg.replace(use_grating_band_prealign=True),
               "pcg": cfg.replace(unwrap_method="wls"),
               "k4": cfg.replace(ecc_loop_kernel=False),
               "deploy": cfg, "no_ecc": cfg.replace(use_ecc_crop_alignment=False),
               "hist": cfg.replace(percentile_method="hist", polyfit_kernel=False)}
    refs, defs = T(streams["refs"][:2]), T(streams["defs"][:2])
    for name, c in configs.items():
        bf = BatchedForce(FTPPipeline(c, P2H, device="cpu"), FORCE)
        got, want = bf.batched_eager(refs, defs), bf.per_stream_eager(refs, defs)
        assert torch.equal(got["force_N"], want["force_N"]), name
    with pytest.raises(ValueError, match="one stream axis"):
        bf.pipe.forward_eager(refs[None], defs[None])
