"""The native-4K routes at 640x480 scale: the deploy preset with
``ecc_downsample_min_px=0``, ``unwrap_downsample_min_px=0`` and
``polyfit_kernel=False``, against the JAX ForcePipeline on the CPU.  This
drives the pooled coarse-to-fine ECC (K4 on the 59x59 coarse grid and the
118x118 polish), the pooled unwrap and the IRLS with K2 through their
plain versions.

Gates (``torch_slice_gates``): force within 1% (measured 0.15%), equal
carrier bins, ``reliable_crop`` agreement >= 99.5% (measured 99.991%), no
kernel launch on the CPU.  The ECC warp is gated within 0.05 px stage by
stage, and end to end within 0.05 px in tx and 0.1 px in ty, because at this
scale the coarse solve does not pin ty: on the 59x59 grid its iterates
wander along a flat ty valley (capping the JAX solve at 40, 50, 57 and 80
iterations gives ty = 0.021, 0.017, 0.026 and 0.052 coarse px), so the
stopping iteration, which rho decides at the level of one f32 ulp, moves the
end-to-end ty between the two packages with the thread count: measured
0.0223 px (1 and 3 torch threads, 4 iterations) and 0.0486 px (2, 4, 6 and
8 threads, 10 iterations) against JAX's 9, up to ~0.07 px seen before.
From the same coarse seed the polish agrees within 1e-5 px.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from vistaf_tpu.ftp.pipeline import FTPPipeline as JaxFTPPipeline
from vistaf_tpu.ops.color import bgr_to_gray
from vistaf_tpu.ops.filters import gaussian_blur
from vistaf_tpu.ops.registration import ecc_align as jax_ecc_align
from vistaf_tpu.utils.synthetic import scaled_ftp_config, synthetic_pair

from vistaf_torch.ftp.pipeline import FTPPipeline
from vistaf_torch.ops.registration import ecc_align

import torch_slice_gates as gates
from torch_threads import single_torch_thread  # noqa: F401  (autouse)

JCFG = scaled_ftp_config(480, 640).deploy().replace(
    ecc_downsample_min_px=0, unwrap_downsample_min_px=0, polyfit_kernel=False)


@pytest.fixture(scope="module")
def runs():
    return gates.run_both(JCFG)


def test_force_within_deploy_contract(runs):
    jres, tres, _ = runs
    assert gates.force_gap(jres, tres) < 0.01


def test_carrier_bins_equal(runs):
    gates.assert_carrier_bins_equal(*runs[:2])


def test_reliable_mask_agrees(runs):
    assert gates.reliable_agreement(*runs[:2]) >= 0.995


def test_ecc_tx_within_tolerance_end_to_end(runs):
    jres, tres, _ = runs
    assert abs(tres["dbg_ecc_warp"][0, 2] - jres["dbg_ecc_warp"][0, 2]) < 0.05
    assert abs(tres["dbg_ecc_rho"] - jres["dbg_ecc_rho"]) < 1e-4


def test_ecc_ty_within_the_flat_valley_end_to_end(runs):
    jres, tres, _ = runs
    assert abs(tres["dbg_ecc_warp"][1, 2] - jres["dbg_ecc_warp"][1, 2]) < 0.1


def test_coarse_to_fine_ecc_stages_match_jax():
    """The coarse solve (K4 route, ``loop_kernel=False``) reaches JAX's rho
    within 1e-5, and the seeded polish (K4 route, ``ecc_polish_iters``)
    from JAX's coarse warp lands within 0.05 px of JAX's (measured 1e-5 px)."""
    ref, de = synthetic_pair(480, 640, JCFG, seed=0)
    jp = JaxFTPPipeline(JCFG, gates.P2H)
    tp = FTPPipeline(gates.ftp_config_from_dict(gates.dataclasses.asdict(JCFG)), gates.P2H,
                     device="cpu")
    x1, x2, y1, y2 = jp.geom.bbox
    gray = [np.asarray(bgr_to_gray(jnp.asarray(f)))[y1:y2, x1:x2] for f in (ref, de)]
    crop01 = jax.vmap(lambda a: gaussian_blur(a, JCFG.ecc_gauss_filt))(
        jnp.asarray(np.stack(gray)) / 255.0)
    crop_t = torch.as_tensor(np.array(crop01))
    kw = dict(mode="euclidean", eps=JCFG.ecc_eps, stride=JCFG.ecc_stride, sampler="shear",
              stall_patience=JCFG.ecc_stall_patience)
    pc, cc, kc = tp._pool_crop(crop_t, JCFG.ecc_coarse_downsample)
    jw, jrho, _ = jax_ecc_align(jnp.asarray(pc[0].numpy()), jnp.asarray(pc[1].numpy()),
                                jnp.asarray(cc.numpy()), max_iters=JCFG.ecc_iters,
                                shear_k=kc, loop_kernel=False, **kw)
    _, rho, _ = ecc_align(pc[0], pc[1], cc, max_iters=JCFG.ecc_iters, shear_k=kc,
                          loop_kernel=False, **kw)
    assert abs(float(rho) - float(jrho)) < 1e-5
    jw = np.asarray(jw)
    f = float(JCFG.ecc_coarse_downsample) / float(JCFG.ecc_downsample)
    seed = np.array([np.arctan2(jw[1, 0], jw[0, 0]), jw[0, 2] * f, jw[1, 2] * f], np.float32)
    p2, c2, k2 = tp._pool_crop(crop_t, JCFG.ecc_downsample)
    jw2, _, _ = jax_ecc_align(jnp.asarray(p2[0].numpy()), jnp.asarray(p2[1].numpy()),
                              jnp.asarray(c2.numpy()), max_iters=JCFG.ecc_polish_iters,
                              shear_k=k2, loop_kernel=JCFG.ecc_loop_kernel,
                              p_init=jnp.asarray(seed), **kw)
    w2, _, _ = ecc_align(p2[0], p2[1], c2, max_iters=JCFG.ecc_polish_iters, shear_k=k2,
                         loop_kernel=JCFG.ecc_loop_kernel, p_init=torch.as_tensor(seed), **kw)
    gap = np.abs(w2.numpy()[:, 2] - np.asarray(jw2)[:, 2]).max() * JCFG.ecc_downsample
    assert gap < 0.05, gap


def test_cpu_run_launched_nothing(runs):
    assert all(v == 0 for v in runs[2].values()), runs[2]
