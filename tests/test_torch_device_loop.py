"""``device_while`` and ``device_if`` in their plain forms (the CPU, the
card's eager forward) against the JAX package's ``lax.while_loop`` and
``lax.cond``, on small seeded inputs.

- The ECC Gauss-Newton loop (``ecc_kernel.gn_loop``) through ``ecc_align``
  at the 640 preset's 236x236 crop, against JAX's ``ecc_align``: the gather
  and the shear sampler, euclidean, translation and affine, a capped solve,
  a ``stall_patience`` stop and cv2's StsNoConv failure.  The trip counts
  are equal; the warps within 1e-4 px (translations) and 5e-5 (the linear
  part), rho within 2e-6: XLA and PyTorch sum the moments in other orders,
  and the gather sampler's port sums them in float64.  The stop test is
  kept off rounding noise by ``eps`` = 1e-5 where the solve converges.
- The WLS unwrap's PCG (``unwrap._wls_pcg_solve``) through ``unwrap_wls``,
  plain and pooled, against JAX's ``unwrap_wls``: the same 2 pi lattice
  index on every masked pixel, within 1e-4 rad.
- The pooled seed pick (``dominant_component``, ``seed_pool=4``) bit-equal
  to JAX on a mask whose pooled seed holds and on one with no interior at
  the pooled scale; the full-resolution seed is computed only on the second.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from vistaf_tpu.ops import components as jcomp
from vistaf_tpu.ops import registration as jreg
from vistaf_tpu.ops import unwrap as jun

from vistaf_torch.ops import components as tcomp
from vistaf_torch.ops import registration as treg
from vistaf_torch.ops import unwrap as tun
from vistaf_torch.ops.consts import DeviceConsts
from torch_threads import single_torch_thread  # noqa: F401  (autouse)

N = 236


def T(a):
    return torch.as_tensor(np.ascontiguousarray(a))


def ecc_scene(th, tx, ty, kind="warped"):
    """A smooth seeded texture (a sum of plane waves) over the crop's disk as
    the template and its copy sampled at the warp (theta, tx, ty), both made
    with numpy; ``kind`` 'flat': a flat template (0.5, exactly centred);
    'same': the template itself as the image."""
    rng = np.random.default_rng(7)
    k = rng.uniform(0.08, 0.3, size=(8, 1, 1))
    ang = rng.uniform(0.0, np.pi, size=(8, 1, 1))
    ph = rng.uniform(0.0, 2 * np.pi, size=(8, 1, 1))

    def tex(x, y):
        return (0.5 + 0.05 * np.sin(k * (np.cos(ang) * x + np.sin(ang) * y) + ph).sum(0)
                ).astype(np.float32)
    yy, xx = np.mgrid[0:N, 0:N].astype(np.float64)
    base = tex(xx, yy)
    moved = tex(np.cos(th) * xx - np.sin(th) * yy + tx, np.sin(th) * xx + np.cos(th) * yy + ty)
    mask = (yy - N // 2) ** 2 + (xx - N // 2) ** 2 <= (N // 2 - 8) ** 2
    if kind == "flat":
        return np.full_like(base, 0.5), moved, mask
    return base, (base if kind == "same" else moved), mask


ROTATED, SHIFTED = (0.004, 0.8, -0.6), (0.0, 0.8, -0.6)
ECC_CASES = {
    # name: (ecc_align keywords, scene kind, scene warp)
    "gather_euclidean": (dict(mode="euclidean", sampler="gather", eps=1e-5), "warped",
                         ROTATED),
    "shear_translation": (dict(mode="translation", sampler="shear", eps=1e-5), "warped",
                          SHIFTED),
    "shear_affine_stride2": (dict(mode="affine", sampler="shear", stride=2, eps=1e-5),
                             "warped", ROTATED),
    "gather_translation_capped": (dict(mode="translation", sampler="gather", max_iters=3),
                                  "warped", SHIFTED),
    # the image is the template: each step is exactly 0 and rho exactly 1,
    # so with eps 0 only the stall rule stops the loop, after 1 + 3 trips
    "shear_euclidean_stall": (dict(mode="euclidean", sampler="shear", stall_patience=3,
                                   eps=0.0), "same", ROTATED),
    "shear_euclidean_stsnoconv": (dict(mode="euclidean", sampler="shear"), "flat", ROTATED),
}


@pytest.mark.parametrize("name", list(ECC_CASES))
def test_gn_loop_matches_jax_ecc_align(name):
    kw, kind, warp = ECC_CASES[name]
    kw = dict(dict(max_iters=100, eps=1e-7, stride=1, shear_k=4, stall_patience=0), **kw)
    base, moved, mask = ecc_scene(*warp, kind=kind)
    jw, jrho, jit = jreg.ecc_align(jnp.asarray(base), jnp.asarray(moved), jnp.asarray(mask),
                                   **kw)
    # loop_kernel=False: a shear euclidean solve takes K4's loop at this
    # size, whose plain version is the same gn_loop
    w, rho, it = treg.ecc_align(T(base), T(moved), T(mask), loop_kernel=False, **kw)
    jw = np.asarray(jw)
    assert it.dtype == torch.int32 and int(it) == int(jit), (int(it), int(jit))
    if kind == "flat":
        assert int(it) == 1 and np.isnan(float(rho)) and np.isnan(float(jrho))
        np.testing.assert_array_equal(w.numpy(), np.eye(2, 3, dtype=np.float32))
        np.testing.assert_array_equal(jw, np.eye(2, 3, dtype=np.float32))
        return
    if name.endswith("capped"):
        assert int(it) == kw["max_iters"]
    if kind == "same":
        assert int(it) == 1 + kw["stall_patience"] and float(rho) == float(jrho) == 1.0
    np.testing.assert_allclose(w.numpy()[:, 2], jw[:, 2], rtol=0, atol=1e-4)
    np.testing.assert_allclose(w.numpy()[:, :2], jw[:, :2], rtol=0, atol=5e-5)
    assert abs(float(rho) - float(jrho)) < 2e-6 and float(rho) > 0.999


def unwrap_scene():
    h = w = N
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    truth = (0.002 * (xx - 100) ** 2 + 0.07 * yy
             + 5.0 * np.exp(-((xx - 130) ** 2 + (yy - 110) ** 2) / 1500))
    wrapped = np.angle(np.exp(1j * truth)).astype(np.float32)
    mask = (yy - 118) ** 2 + (xx - 118) ** 2 <= 105 ** 2
    mask &= ~((yy - 60) ** 2 + (xx - 90) ** 2 <= 60)
    return wrapped, mask


@pytest.mark.parametrize("downsample", [1, 4], ids=["plain", "pooled"])
def test_pcg_matches_jax_unwrap(downsample):
    wrapped, mask = unwrap_scene()
    want = np.asarray(jun.unwrap_wls(jnp.asarray(wrapped), jnp.asarray(mask), cg_iters=16,
                                     downsample=downsample))
    got = tun.unwrap_wls(T(wrapped), T(mask), DeviceConsts("cpu"), cg_iters=16,
                         downsample=downsample).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got[mask], want[mask], rtol=0, atol=1e-4)


def test_pcg_trip_count_is_the_loops(monkeypatch):
    """The state's trip count stops at ``cg_iters`` or at the tolerance, as
    JAX's ``it`` does: the cap of 8 with the default tolerance, fewer with a
    loose one."""
    wrapped, mask = unwrap_scene()
    seen = []
    real = tun.device_while

    def spy(cond, body, state, **kw):
        real(cond, body, state, **kw)
        seen.append(int(state[-1]))
    monkeypatch.setattr(tun, "device_while", spy)
    for tol in (1e-8, 1e-2):
        tun.unwrap_wls(T(wrapped), T(mask), DeviceConsts("cpu"), cg_iters=8, tol=tol)
    assert seen[0] == 8 and 1 <= seen[1] < 8, seen


def seed_masks():
    """test_torch_ccl.py's two masks of the pick (64x96, whose JAX compile
    the two files share through the persistent compilation cache)."""
    yy, xx = np.mgrid[0:64, 0:96]
    disks = ((yy - 30) ** 2 + (xx - 30) ** 2 <= 14 ** 2) | ((yy - 40) ** 2 + (xx - 75) ** 2
                                                          <= 9 ** 2)
    thin = np.zeros((64, 96), bool)
    thin[10, 5:60] = thin[40:43, 70:90] = True
    return {"pooled_seed_holds": disks, "no_pooled_interior": thin}


@pytest.mark.parametrize("kind", ["pooled_seed_holds", "no_pooled_interior"])
def test_seed_pick_matches_jax_cond(monkeypatch, kind):
    m = seed_masks()[kind]
    fine = []
    real = tcomp._fine_seed
    monkeypatch.setattr(tcomp, "_fine_seed", lambda mask: fine.append(1) or real(mask))
    want = np.asarray(jcomp.dominant_component(jnp.asarray(m), seed_pool=4))
    np.testing.assert_array_equal(tcomp.dominant_component(T(m), 4).numpy(), want)
    assert 0 < want.sum() < m.sum()
    assert len(fine) == (kind == "no_pooled_interior")
