"""Chip smoke test of the PyTorch + CUDA port (vistaf_torch) on one GPU.

    python3 chip_smoke.py

Phases, one line each, any failure raises and exits non-zero:
  1. device: requires CUDA, prints the card's name and power limit;
  2. build: compiles the Hopper kernels from vistaf_torch/csrc;
  3. kernels: each of the eight kernels against its plain PyTorch version on
     the card at the shapes its paths give it (K3 also at the parity
     paths': the demod's pair of 236x236 crops, 24 iterations, the pair of
     1182x1182 crops and the hole fill's 1182x1182 plane, 64, and the
     temperature parity path's full 2160x3840 plane, the WIDE fill's 96
     iterations and the COLOR fill's 48; 236x236 planes for K1, K3,
     K5, K6, K7; the 295x295 coarse ECC grid for K4, its whole loop unseeded
     under the native-4K preset's iterations, eps and stall patience, the
     loop seeded, and one iteration's matrix; the 1182x1182 crop of the
     native-4K force path for K1, K2 and K3; the 2160x3840 gray plane for
     K1, and the 1608x1664 compute crop for K3 and K8, of the native-4K
     temperature path) and K7, K5 and K6 also at the largest plane their
     budgets admit (584x512, 352x256, 448x384), with CUDA-event median
     times of both, the kernel's device time under torch.profiler (its own
     kernels, without the host's enqueue), the bound (bytes over 3.35 TB/s
     or float32 operations over 67 TFLOP/s, whichever is longer) and, where
     one PyTorch call computes the same function (K1: torch.nanquantile),
     that call's time; K8 also with models of no term and no calibrator
     (LAB, gray and chroma only);
  4. end to end at 640x480: ForcePipeline under the deploy preset as
     shipped, K1, K3, K5, K6 and K7 must launch, force within 1% of the
     same port run on the CPU;
  5. end to end at 2160x3840: ForcePipeline under FTPConfig().deploy(), K1,
     K2, K3 and K4 must launch, force within 1% and the ECC warp within
     0.05 px of the port's CPU run;
  6. end to end at 2160x3840: TemperaturePipeline under TempConfig().deploy()
     on a synthetic thermochromic frame with models of the shipped form, K1,
     K3 and K8 must launch, against the port's CPU run: equal carrier bin,
     t_mean within 0.1 degC, t_min and t_max within 0.75 degC, valid pixels
     within 0.5%, and COLOR on at least 1% of the ROI;
  7. multimodal at 2160x3840: MultimodalPipeline over the 4K force and
     temperature pipelines, on a frame pair that carries the grating and the
     thermochromic colours (``compose_multimodal_frame``); K1, K2, K3, K4
     and K8 must launch; ``__call__`` bit-equal to the two pipelines alone,
     ``step_fused(maps)`` and ``(scalars)`` within the gates of
     tests/test_multimodal_fused.py, the scalar fetch one device-to-host
     copy of the scalars; against the port's CPU run: force within 1%,
     t_mean within 0.1 degC, t_min and t_max within 0.75 degC, valid pixels
     within 0.5%, COLOR on at least 1% of the ROI;
  8. streams at 640x480: StreamingForce over BatchedForce, 4 streams, window
     8, EMA 0.2, 6 batches through run_overlapped; K1, K3, K5, K6 and K7 must
     launch; bit-equal to the serialized calls, each stream to _single and
     the smoothing to the port's CPU update; p50 per batch and fps;
  8b. the parity preset (the CLI's default numerics), end to end at 640x480
     (``scaled_ftp_config(480, 640)``, phase ``parity640``) and at 2160x3840
     (``FTPConfig()``, phase ``parity4k``): K3 must launch twice a frame (the
     demod's glare repair and the hole fill) and no other kernel at all (a
     launch of K1, K2 or K4-K7 would be a deploy route leaking in).  Against
     the port's CPU run given the card's alignment (``same_alignment``):
     the global shift within 0.02 px, the CPU's own ECC from that shift
     within 0.05 px of the card's warp, force within 1%.  The free-running
     CPU run is gated the same way (force 1%, ECC 0.05 px) at 640x480 and
     only reported at 2160x3840, where the scene leaves the parity ECC's ty
     undetermined (``ALIGNMENT_UNDETERMINED``); its line also gives the
     CPU run's seconds; and ``ForcePipeline.from_artifacts`` over
     calibration JSONs written to a temporary directory gives the parity640
     force of the constructor-built pipeline;
  8c. the temperature parity preset (``TempConfig()``, the CLI's default
     temperature numerics) at 2160x3840 (phase ``temp4k_parity``): K3 must
     launch exactly twice a frame (the WIDE and COLOR fills) and no other
     kernel; against the port's CPU run the gates of phase 6; the gap to the
     deploy preset on the same frame is reported, not gated;
  8d. multimodal under the parity presets (``FTPConfig()`` and
     ``TempConfig()``) at 2160x3840 (phase ``mm4k_parity``): K3 exactly four
     times a frame and no other kernel, in ``__call__`` and in
     ``step_fused(scalars)``; ``__call__`` bit-equal to the two pipelines
     alone, ``step_fused`` within the gates of phase 7 and its scalar fetch
     one device-to-host copy; the force held to the port's CPU run given the
     card's alignment as on ``parity4k`` (free-running only reported), the
     temperature to the CPU run with the gates of phase 6;
  9. timing: steady-state p50/p90, fps and the host syncs one frame makes,
     for each path (fewer frames at 4K; the temperature path both through
     __call__, which fetches every map, and through stats(); multimodal
     through __call__ and step_fused(scalars));
  10. profile: device busy share and the heaviest kernels of a few frames of
     each path under torch.profiler.
Then the card line, one JSON line with the kernel table and, last, the
device line.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
import warnings

import numpy as np

H, W = 480, 640
H4K, W4K = 2160, 3840
SEED = 0
# calibration models of the 640x480 benchmark (bench.py)
P2H_MODEL = {"type": "hinge_saturating",
             "params": {"a": 2.0826494996246554, "b": 4.20441143052732,
                        "c": -1.767844217125454e-09}}
FORCE_MODEL = {"type": "growth",
               "params": {"a": 1.6197727931063521, "b": 9.756634595755994}}
FORCE_RTOL = 0.01          # the deploy preset's 1% force contract
ECC_ATOL_PX = 0.05         # ECC warp translation, card vs CPU
# the global shift, card vs CPU: the whitened cross-power spectrum amplifies
# FFT rounding (pocketfft against XLA's FFT: 0.006 px, tests/test_torch_slice.py)
SHIFT_ATOL_PX = 0.02
# paths also held to the port's CPU run given the card's alignment
# (``same_alignment``), and the one whose free-running comparison is only
# reported: on the native-4K synthetic pair the parity ECC's ty is not
# determined to ECC_ATOL_PX (the vertical grating leaves it nearly flat, and
# a 0.003 px change of the global shift moves the CPU's own stop from 15 to
# 19-23 iterations and ty by 0.1-0.2 px), so the card's and the CPU's
# global shifts, ~0.006 px apart, end 0.4 px apart in ty and 3.6% apart in
# force (x17 through the 4K growth model)
SAME_ALIGNMENT_PATHS = ("parity640", "parity4k", "mm4k_parity")
ALIGNMENT_UNDETERMINED = ("parity4k", "mm4k_parity")
# the temperature deploy contract (the JAX TempConfig.deploy): scene mean
# within 0.1 degC, hottest/coldest pixel within 0.75 degC
T_MEAN_ATOL, T_EXTREME_ATOL, VALID_RTOL, COLOR_MIN_SHARE = 0.1, 0.75, 0.005, 0.01
# H100 SXM peaks (NVIDIA data sheet, 700 W): HBM bytes/s, float32 FLOP/s
# outside the tensor cores
HBM_BPS, FP32_OPS = 3.35e12, 67e12
# kernels each path must launch (the JAX package's Pallas routes at that size)
PATH_KERNELS = {
    "640": ("masked_quantiles", "inpaint_diffusion", "ecc_loop_euclidean", "unwrap_wls",
            "robust_polyfit2d"),
    "4k": ("masked_quantiles", "masked_median_mad", "inpaint_diffusion",
           "gn_moments_euclidean"),
    "temp4k": ("masked_quantiles", "inpaint_diffusion", "fused_temperature"),
    "mm4k": ("masked_quantiles", "masked_median_mad", "inpaint_diffusion",
             "gn_moments_euclidean", "fused_temperature"),
    "streams640": ("masked_quantiles", "inpaint_diffusion", "ecc_loop_euclidean",
                   "unwrap_wls", "robust_polyfit2d"),
    "parity640": ("inpaint_diffusion",),
    "parity4k": ("inpaint_diffusion",),
    "temp4k_parity": ("inpaint_diffusion",),
    "mm4k_parity": ("inpaint_diffusion",),
}
# the parity paths' whole launch count a frame: K3 in the demod and in the
# hole fill of the force path, in the WIDE and COLOR fills of the
# temperature path, every other kernel none (sort percentiles, the gather
# ECC, the plain PCG, the non-fused IRLS and the unfused LAB and models are
# the JAX package's XLA routes on a TPU)
PATH_EXACT_LAUNCHES = {"parity640": {"inpaint_diffusion": 2},
                       "parity4k": {"inpaint_diffusion": 2},
                       "temp4k_parity": {"inpaint_diffusion": 2},
                       "mm4k_parity": {"inpaint_diffusion": 4}}
# the multimodal gates of tests/test_multimodal_fused.py: step_fused(maps)
# against __call__, step_fused(scalars) against step_fused(maps)
MM_HEIGHT_RTOL, MM_HEIGHT_ATOL, MM_SCALAR_REL = 1e-5, 1e-6, 1e-4
MM_TMAP_ATOL, MM_STATS_ATOL, MM_FETCH_REL = 1e-4, 1e-3, 1e-6
# BASELINE config 4 (scripts/bench_streams.py): 4 streams, window 8, EMA 0.2
STREAMS, WINDOW, EMA_ALPHA, BATCHES = 4, 8, 0.2, 6
DENTS_RAD = (0.8, 0.0, 0.5, 0.3, 0.7, 0.1)


def say(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median milliseconds of fn() over ``reps`` runs, CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def device_ms(fn, reps: int = 10) -> float:
    """Milliseconds of kernel and copy time on the card per call of fn()
    (``torch.profiler``, device-side events), without the host's enqueue:
    beside ``cuda_ms`` it tells a kernel bound by its launches from one
    bound by the card."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e3 / reps


def kernel_cases(device):
    """Inputs at the slice's shapes, made with numpy from SEED, and the
    check each kernel's output must pass against its plain version."""
    import torch
    from vistaf_torch.config import FTPConfig, TempConfig, slice_ftp_config
    from vistaf_torch.ftp.pipeline import FTPGeometry
    from vistaf_torch.kernels import (ecc_kernel, ecc_loop_kernel, inpaint_kernel,
                                      polyfit_kernel, quantile_kernel, temp_kernel,
                                      unwrap_kernel)
    from vistaf_torch.ops import geometry
    from vistaf_torch.temperature.inference import TemperaturePipeline
    from vistaf_torch.utils.synthetic import scaled_ftp_config, synthetic_deploy_temp_weights
    from vistaf_torch.ops.registration import ecc_prepare

    cfg = slice_ftp_config(H, W)
    g = FTPGeometry.from_config(cfg)
    h, w = g.crop_h, g.crop_w
    rng = np.random.default_rng(SEED)
    circ = geometry.circular_mask(h, w, g.cx_local, g.cy_local, g.r_local)
    t = lambda a: torch.as_tensor(a, device=device)

    # K1: pair of planes, 3 quantiles, circular mask with a NaN speck
    xq = rng.normal(size=(2, h, w)).astype(np.float32)
    xq[:, 100:104, 90:95] = np.nan
    k1_args = (t(xq), t(np.broadcast_to(circ, (2, h, w)).copy()), (92.0, 95.0, 98.0))

    # K3: integer gray pair with glare specks to fill
    gray = np.round(rng.uniform(60, 200, size=(2, h, w))).astype(np.float32)
    fill = rng.random((2, h, w)) > 0.995
    k3_args = (t(gray), t(fill), cfg.inpaint_iters)

    # K5: the ECC solve between a smooth template and a shifted, rotated copy
    from vistaf_torch.ops.filters import gaussian_blur
    from vistaf_torch.ops.consts import DeviceConsts
    from vistaf_torch.ops.warp import warp_affine_inverse_shear
    consts = DeviceConsts(device)
    base = gaussian_blur(t(rng.random((h, w)).astype(np.float32)), 3.0, consts)
    th, tx, ty = 0.003, 0.6, -0.4
    M = t(np.array([[np.cos(th), -np.sin(th), tx], [np.sin(th), np.cos(th), ty]],
                   np.float32))
    moved = warp_affine_inverse_shear(base, M, K=4)
    smask = torch.zeros((h, w), dtype=torch.float32, device=device)
    smask[::2, ::2] = 1.0
    S_cf, Tc = ecc_prepare(base, moved, t(circ))
    k5_args = (S_cf, Tc, smask, cfg.ecc_shear_k, cfg.ecc_iters, cfg.ecc_eps,
               cfg.ecc_stall_patience)

    # K7: quadratic surface + noise + outliers over an eroded disk
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    z = (0.3 + 1e-3 * xx - 2e-3 * yy + 2e-5 * xx * xx - 1e-5 * xx * yy + 3e-5 * yy * yy
         + rng.normal(scale=0.02, size=(h, w))).astype(np.float32)
    z[rng.random((h, w)) > 0.97] += 3.0
    k7_args = (t(z), t(circ), 2, cfg.polyfit_iters, 4.685, cfg.polyfit_resigma_iters)

    # K2: a native-4K crop (1182x1182) of noise with outliers over a disk
    n4 = 1182
    x2 = rng.normal(size=(n4, n4)).astype(np.float32)
    x2[rng.random((n4, n4)) > 0.98] += 5.0
    yy4, xx4 = np.mgrid[0:n4, 0:n4]
    disk4 = (yy4 - n4 // 2) ** 2 + (xx4 - n4 // 2) ** 2 <= (n4 // 2 - 2) ** 2
    k2_args = (t(x2), t(disk4))

    # K1 and K3 at the native-4K path's shapes: the demod's pair of 1182x1182
    # crops over the crop's circle, its first quantile level and its
    # inpaint iterations
    cfg4 = FTPConfig().deploy()
    g4 = FTPGeometry.from_config(cfg4)
    h4, w4 = g4.crop_h, g4.crop_w
    circ4 = geometry.circular_mask(h4, w4, g4.cx_local, g4.cy_local, g4.r_local)
    xq4 = rng.normal(size=(2, h4, w4)).astype(np.float32)
    xq4[:, 500:504, 600:605] = np.nan
    k1_4k_args = (t(xq4), t(np.broadcast_to(circ4, (2, h4, w4)).copy()),
                  (cfg4.bad_intensity_percentile,))
    gray4 = np.round(rng.uniform(60, 200, size=(2, h4, w4))).astype(np.float32)
    k3_4k_args = (t(gray4), t(rng.random((2, h4, w4)) > 0.995), cfg4.inpaint_iters)

    # K3 at the parity paths' shapes: the demod's pair of 236x236 crops at
    # the scaled preset's 24 iterations, and at native 4K the pair of
    # 1182x1182 crops and the hole fill's single plane at 64
    par = scaled_ftp_config(H, W)
    gray_p = np.round(rng.uniform(60, 200, size=(2, h, w))).astype(np.float32)
    k3_par_args = (t(gray_p), t(rng.random((2, h, w)) > 0.995), par.inpaint_iters)
    cfg_p4 = FTPConfig()
    gray_p4 = np.round(rng.uniform(60, 200, size=(2, h4, w4))).astype(np.float32)
    k3_par4k_args = (t(gray_p4), t(rng.random((2, h4, w4)) > 0.995), cfg_p4.inpaint_iters)
    k3_hole4k_args = (t(gray_p4[0].copy()), t(rng.random((h4, w4)) > 0.999),
                      cfg_p4.inpaint_iters)

    # K4 on the 295x295 coarse grid of the 4K preset, K = 4: the whole loop
    # unseeded under the preset's iterations, eps and stall patience, the
    # loop seeded near the warp, and one GN iteration's matrix
    n_c = 295
    base_c = gaussian_blur(t(rng.random((n_c, n_c)).astype(np.float32)), 2.0, consts)
    moved_c = warp_affine_inverse_shear(base_c, M, K=4)
    yyc, xxc = np.mgrid[0:n_c, 0:n_c]
    disk_c = (yyc - n_c // 2) ** 2 + (xxc - n_c // 2) ** 2 <= (n_c // 2 - 1) ** 2
    S_c, T_c = ecc_prepare(base_c, moved_c, t(disk_c))
    sm_c = torch.zeros((n_c, n_c), dtype=torch.float32, device=device)
    sm_c[::2, ::2] = 1.0
    co = ecc_kernel.shear_coeffs(t(np.array([0.002, 0.3, -0.2], np.float32)))
    k4_args = (S_c, T_c, sm_c, co, 4)
    loop4 = (cfg4.ecc_iters, cfg4.ecc_eps, cfg4.ecc_stall_patience)
    k4_loop_args = (S_c, T_c, sm_c, torch.zeros(3, dtype=torch.float32, device=device), 4,
                    *loop4)
    k4_seeded_args = (S_c, T_c, sm_c, t(np.array([0.002, 0.5, -0.3], np.float32)), 4, *loop4)

    # K6: wrapped phase of a smooth field with a ramp, over the crop's disk
    field = gaussian_blur(t(rng.standard_normal((h, w)).astype(np.float32)), 12.0,
                          consts) * 60.0
    field = field + t((0.09 * xx + 0.05 * yy).astype(np.float32))
    wrapped = torch.atan2(torch.sin(field), torch.cos(field))
    k6_args = (wrapped, t(circ), consts, cfg.unwrap_cg_iters, cfg.unwrap_cg_tol)

    def k1_check(a, b):
        assert torch.equal(a, b), (a, b)          # bit-equal: exact counts
        return float((a - b).abs().max())

    def k3_check(a, b):
        err = float((a - b).abs().max())
        assert err <= 1e-5, err                   # integer data: exact mean
        return err

    def k5_check(a, b):
        (pa, ra, ia, fa), (pb, rb, ib, fb) = a, b
        assert bool(fa) == bool(fb), (fa, fb)
        assert abs(float(ra) - float(rb)) < 1e-4, (ra, rb)
        d = (pa - pb).abs()
        assert float(d[0]) < 5e-5 and float(d[1:].max()) < 5e-3, (pa, pb)
        return float(d.max())

    def k4_loop_check(a, b):
        say("kernel_check", name="gn_loop_euclidean", iters=int(a[2]), iters_plain=int(b[2]),
            p=a[0].tolist(), p_plain=b[0].tolist())
        assert 1 <= int(a[2]), a
        return k5_check(a, b)

    def k7_check(a, b):
        err = float((a - b).abs().max())
        assert err <= 1e-4 * float(b.abs().max()), (a, b)
        return err

    def k2_check(a, b):
        for x, y in zip(a, b):
            assert torch.equal(x, y), (a, b)      # bit-equal: exact counts
        return 0.0

    def k4_check(a, b):
        # each entry within 1e-5 of its Cauchy-Schwarz scale sqrt(b_ii b_jj):
        # the summation order is all that differs
        d = torch.sqrt(b.diagonal())
        rel = float(((a - b).abs() / torch.outer(d, d)).max())
        say("kernel_check", name="gn_moments_euclidean", worst_entry_rel=rel)
        assert rel <= 1e-5, (a, b)
        return float((a - b).abs().max())

    def k6_check(a, b):
        na, nb = torch.isnan(a), torch.isnan(b)
        assert torch.equal(na, nb)
        m = ~nb
        # congruent outputs: the same 2 pi lattice index on >= 99.9% of pixels
        same_k = (torch.abs(a[m] - b[m]) < 1e-3).float().mean()
        assert float(same_k) >= 0.999, float(same_k)
        return float((a[m] - b[m]).abs().max())

    # K1, K3 and K8 at the native-4K temperature path's shapes: the median
    # of the 2160x3840 gray over its effective ROI, and the 1608x1664
    # compute crop's 16-iteration WIDE inpaint and fused models
    tcfg = TempConfig().deploy()
    y0, y1, x0, x1 = TemperaturePipeline.compute_bbox(tcfg)
    outer = geometry.circle_from_3_points_exact(tcfg.outer_circle_p1, tcfg.outer_circle_p2,
                                                tcfg.outer_circle_p3)
    roi_t = geometry.circular_mask(H4K, W4K, *outer)
    gray_t = np.round(rng.uniform(0, 255, size=(H4K, W4K))).astype(np.float32)
    k1_t_args = (t(gray_t), t(roi_t & (rng.random((H4K, W4K)) > 0.01)), (50.0,))
    hc, wc = y1 - y0, x1 - x0
    gray_c = np.round(rng.uniform(0, 255, size=(hc, wc))).astype(np.float32)
    k3_t_args = (t(gray_c), t(rng.random((hc, wc)) > 0.995), tcfg.wide_inpaint_iters)
    color, wide = synthetic_deploy_temp_weights(SEED)
    roi_c = t(roi_t[y0:y1, x0:x1].copy())
    k8_args = (t(np.round(rng.uniform(0, 255, size=(hc, wc, 3))).astype(np.float32)), roi_c,
               roi_c & t(rng.random((hc, wc)) > 0.5))
    k8_fn = temp_kernel.make_fused_temperature_fn(tcfg.color_chroma_min, color, wide)

    def k8_plain(bgr, roi, cpre):
        return temp_kernel.fused_temperature_maps_plain(bgr, roi, cpre,
                                                        tcfg.color_chroma_min, color, wide)

    def k8_check(a, b):
        # test_pallas_temp.py's tolerance: expf/logf/powf of two libraries
        # can flip an 8-bit LAB step on a .5 boundary
        errs = []
        for x, y in zip(a[:2], b[:2]):
            both = torch.isfinite(x) & torch.isfinite(y)
            assert float((torch.isfinite(x) != torch.isfinite(y)).float().mean()) < 2e-3
            d = (x[both] - y[both]).abs()
            assert float((d > 1e-2).float().mean()) < 2e-3
            assert float(torch.quantile(d, 0.995)) < 0.5
            errs.append(float(d.max()))
        assert float((a[2] != b[2]).float().mean()) < 2e-3
        return max(errs)

    # K7 at the largest plane its budget admits (584x512 pads to 299,008 of
    # 300,000 elements): the same kind of surface over a disk (drawn last,
    # so that the other cases keep their inputs)
    hb, wb = 584, 512
    assert polyfit_kernel.fits((hb, wb))
    yb, xb = np.mgrid[0:hb, 0:wb].astype(np.float32)
    zb = (0.3 + 1e-3 * xb - 2e-3 * yb + 2e-5 * xb * xb - 1e-5 * xb * yb + 3e-5 * yb * yb
          + rng.normal(scale=0.02, size=(hb, wb))).astype(np.float32)
    zb[rng.random((hb, wb)) > 0.97] += 3.0
    diskb = (yb - hb // 2) ** 2 + (xb - wb // 2) ** 2 <= (wb // 2 - 4) ** 2
    k7_big_args = (t(zb), t(diskb), 2, cfg.polyfit_iters, 4.685, cfg.polyfit_resigma_iters)

    # K5 and K6 at the edge of their budgets: the ECC solve on a 352x256
    # plane (pads to 90,112 of 90,416 elements) and the unwrap of a 448x384
    # plane (already (8, 128)-aligned, 172,032 of 240,000 elements); the
    # same kinds of scene as at the crop
    he, we = 352, 256
    assert ecc_loop_kernel.fits((he, we))
    base_e = gaussian_blur(t(rng.random((he, we)).astype(np.float32)), 3.0, consts)
    S_e, T_e = ecc_prepare(base_e, warp_affine_inverse_shear(base_e, M, K=4),
                           t(geometry.circular_mask(he, we, we / 2, he / 2, we / 2 - 2)))
    sm_e = torch.zeros((he, we), dtype=torch.float32, device=device)
    sm_e[::2, ::2] = 1.0
    k5_big_args = (S_e, T_e, sm_e, cfg.ecc_shear_k, cfg.ecc_iters, cfg.ecc_eps,
                   cfg.ecc_stall_patience)
    hu, wu = 448, 384
    assert unwrap_kernel.fits((hu, wu))
    yu, xu = np.mgrid[0:hu, 0:wu].astype(np.float32)
    field_u = gaussian_blur(t(rng.standard_normal((hu, wu)).astype(np.float32)), 12.0,
                            consts) * 60.0 + t((0.09 * xu + 0.05 * yu).astype(np.float32))
    k6_big_args = (torch.atan2(torch.sin(field_u), torch.cos(field_u)),
                   t(geometry.circular_mask(hu, wu, wu / 2, hu / 2, wu / 2 - 6)), consts,
                   cfg.unwrap_cg_iters, cfg.unwrap_cg_tol)

    # K3 at the temperature parity path's shapes (drawn last): the full
    # 2160x3840 plane of 8-bit levels, known on the outer ROI less 0.5% of
    # holes for the WIDE fill's 96 iterations, on the ROI's light stripes
    # (12 px, tilted 8 degrees) for the COLOR fill's 48; everything else is
    # filled, as inpaint_within_roi asks it
    pcfg = TempConfig()
    levels = t(np.round(rng.uniform(0, 255, size=(H4K, W4K))).astype(np.float32))
    known_w = roi_t & (rng.random((H4K, W4K)) > 0.005)
    yt, xt = np.mgrid[0:H4K, 0:W4K].astype(np.float32)
    stripes = np.cos((2.0 * np.pi / 12.0) * (np.cos(0.14) * xt + np.sin(0.14) * yt)) > 0
    del yt, xt
    k3_pw_args = (levels, t(~known_w), pcfg.wide_inpaint_iters)
    k3_pc_args = (levels, t(~(known_w & stripes)), pcfg.color_inpaint_iters)

    def k3_far_check(a, b, args):
        """Bit-equal wherever a step reaches (within ``iters`` pixels of a
        known one, Chebyshev); beyond, both hold the initial mean of ~3e6
        known levels, whose float32 sums pass 2**24 and so round in each
        one's order: within a relative 1e-6."""
        import torch.nn.functional as F
        it = int(args[2])
        k = (~args[1]).to(torch.float32)[None, None]
        near = F.max_pool2d(F.max_pool2d(k, (1, 2 * it + 1), 1, (0, it)),
                            (2 * it + 1, 1), 1, (it, 0))[0, 0] > 0
        assert torch.equal(a[near], b[near]), float((a[near] - b[near]).abs().max())
        far = float((a[~near] - b[~near]).abs().max()) if bool((~near).any()) else 0.0
        assert far <= 1e-6 * float(b.abs().max()), far
        say("kernel_check", name="inpaint_diffusion", iters=it, reached_share=float(
            near.float().mean()), unreached_max_abs_err=far)
        return far

    k1 = ("masked_quantiles", "vistaf_torch/csrc/quantile.cu",
          "vistaf_tpu/pallas/quantile_kernel.py:91",
          quantile_kernel.masked_quantiles, quantile_kernel.masked_quantiles_plain)
    k3 = ("inpaint_diffusion", "vistaf_torch/csrc/inpaint.cu",
          "vistaf_tpu/pallas/inpaint_kernel.py:94",
          inpaint_kernel.inpaint_diffusion, inpaint_kernel.inpaint_diffusion_plain)
    k5 = ("ecc_loop_euclidean", "vistaf_torch/csrc/ecc_loop.cu",
          "vistaf_tpu/pallas/ecc_loop_kernel.py:161",
          ecc_loop_kernel.ecc_loop_euclidean, ecc_loop_kernel.ecc_loop_euclidean_plain)
    k4 = ("gn_moments_euclidean", "vistaf_torch/csrc/ecc_gn_loop.cu",
          "vistaf_tpu/pallas/ecc_kernel.py:118")
    k6 = ("unwrap_wls", "vistaf_torch/csrc/unwrap.cu",
          "vistaf_tpu/pallas/unwrap_kernel.py:148",
          unwrap_kernel.unwrap_wls, unwrap_kernel.unwrap_wls_plain)
    k7 = ("robust_polyfit2d", "vistaf_torch/csrc/polyfit.cu",
          "vistaf_tpu/pallas/polyfit_kernel.py:144",
          polyfit_kernel.robust_polyfit2d_coef, polyfit_kernel.robust_polyfit2d_coef_plain)
    return [
        (*k1, k1_args, k1_check),
        (*k1, k1_4k_args, k1_check),
        (*k1, k1_t_args, k1_check),
        (*k3, k3_args, k3_check),
        (*k3, k3_4k_args, k3_check),
        (*k3, k3_t_args, k3_check),
        (*k3, k3_par_args, k3_check),
        (*k3, k3_par4k_args, k3_check),
        (*k3, k3_hole4k_args, k3_check),
        (*k3, k3_pw_args, lambda a, b: k3_far_check(a, b, k3_pw_args)),
        (*k3, k3_pc_args, lambda a, b: k3_far_check(a, b, k3_pc_args)),
        ("fused_temperature", "vistaf_torch/csrc/temp.cu",
         "vistaf_tpu/pallas/temp_kernel.py:139", k8_fn, k8_plain, k8_args, k8_check),
        (*k5, k5_args, k5_check),
        (*k7, k7_args, k7_check),
        (*k7, k7_big_args, k7_check),
        ("masked_median_mad", "vistaf_torch/csrc/quantile.cu",
         "vistaf_tpu/pallas/quantile_kernel.py:133",
         quantile_kernel.masked_median_mad, quantile_kernel.masked_median_mad_plain,
         k2_args, k2_check),
        (*k4, ecc_kernel.gn_loop_euclidean, ecc_kernel.gn_loop_euclidean_plain, k4_loop_args,
         k4_loop_check),
        (*k4, ecc_kernel.gn_loop_euclidean, ecc_kernel.gn_loop_euclidean_plain, k4_seeded_args,
         k4_loop_check),
        (*k4, ecc_kernel.gn_moments_euclidean, ecc_kernel.gn_moments_euclidean_plain,
         k4_args, k4_check),
        (*k6, k6_args, k6_check),
        (*k5, k5_big_args, k5_check),
        (*k6, k6_big_args, k6_check),
    ]


def work(name: str, args, out):
    """(bytes, float32 operations) one call needs on these inputs: each
    input read once and each output written once; operations counted per
    element from the algorithm (a compare, add, multiply or transcendental
    is one), with data-dependent trip counts taken from this call."""
    from vistaf_torch.kernels import polyfit_kernel, quantile_kernel, temp_kernel, unwrap_kernel
    from vistaf_torch.utils.synthetic import synthetic_deploy_temp_weights
    x = args[0]
    n = x.numel()
    if name == "fused_temperature":
        # every pixel's LAB, the WIDE model on roi_eff and the COLOR model
        # on the final colour support, with the models kernel_cases built
        color, wide = synthetic_deploy_temp_weights(SEED)
        hw = args[1].numel()
        return 23 * hw, temp_kernel.op_count(wide, color, hw, int(args[1].sum()),
                                             int(out[2].sum()))
    if name == "masked_quantiles":       # min, max; per level a compare and a count
        q = len(args[2])
        return 5 * n + 4 * out.numel(), n * (2 + 2 * quantile_kernel.LEVELS * q)
    if name == "masked_median_mad":      # median levels; |x - med|; MAD levels
        ml = quantile_kernel.MAD_LEVELS
        return 5 * n + 8, n * (2 + 2 * ml + 2 + 2 * ml)
    if name == "inpaint_diffusion":      # per step: two 3x3 box sums, update
        return 9 * n, n * (2 + 24 * int(args[2]))
    hw = args[1].numel()
    taps = 2 * int(args[3] if name == "ecc_loop_euclidean" else args[4]) + 1
    per_iter = hw * (2 * taps * (4 + 4 * 2) + 60)   # two hat passes, moment rows
    if name == "gn_moments_euclidean" and isinstance(out, tuple):   # K4's loop
        return 4 * (6 * hw + 3 + 6), per_iter * max(1, int(out[2]))
    if name == "gn_moments_euclidean":
        return 4 * (6 * hw + 8 + 36), per_iter
    if name == "ecc_loop_euclidean":
        return 4 * (6 * hw + 6), per_iter * max(1, int(out[2]))
    if name == "unwrap_wls":             # PCG: 4 DCT products a preconditioner
        hp, wp = unwrap_kernel.padded_shape(x.shape)
        apps = int(args[3]) + 1
        mats = 2 * (hp * hp + wp * wp) + hp * wp
        return 9 * n + 4 * mats, apps * 4 * hp * wp * (hp + wp) + hp * wp * 40 * apps
    if name == "robust_polyfit2d":       # per round 27 weighted sums; bisections
        ncoef = out.numel()
        levels = polyfit_kernel.LEVELS
        return 5 * n + 4 * ncoef, n * (int(args[3]) * (54 + 2 * ncoef + 6)
                                       + int(args[5]) * (4 * levels + 2))
    raise KeyError(name)


def k8_lab_only():
    """K8 with the deploy models stripped of every term and calibrator: the
    kernel then runs LAB, gray and chroma only, so its time is theirs."""
    import dataclasses
    from vistaf_torch.config import TempConfig
    from vistaf_torch.kernels.temp_kernel import make_fused_temperature_fn
    from vistaf_torch.utils.synthetic import synthetic_deploy_temp_weights
    bare = [dataclasses.replace(m, coef=np.zeros_like(m.coef), iso_x=None, iso_y=None)
            for m in synthetic_deploy_temp_weights(SEED)]
    return make_fused_temperature_fn(TempConfig().deploy().color_chroma_min, *bare)


def library_call(name: str, args):
    """One PyTorch call that computes the kernel's function, or None: only
    K1 has one (torch.nanquantile over the plane with NaN outside the
    mask, prepared outside the timed call)."""
    import torch
    if name != "masked_quantiles":
        return None
    x, m, qs = args
    xn = torch.where(m.expand(x.shape), x, float("nan")).reshape(-1, x.shape[-2] * x.shape[-1])
    q = torch.tensor([v / 100.0 for v in qs], dtype=torch.float32, device=x.device)
    return lambda: torch.nanquantile(xn, q, dim=-1)


def bound_ms(nbytes: int, ops: int):
    t_bytes, t_ops = nbytes / HBM_BPS * 1e3, ops / FP32_OPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def phase_kernels(device):
    """One row per kernel: ``max_abs_err`` over every shape it was checked
    at; ``ms``, ``plain_ms``, ``bound_ms`` and ``library_ms`` at the first;
    each shape's numbers under ``shapes``."""
    import torch
    rows = {}
    for case in kernel_cases(device):
        name, source, replaces, kern, plain, args, check = case
        got = kern(*args)
        ref = plain(*args)
        torch.cuda.synchronize()
        err = check(got, ref)
        nbytes, ops = work(name, args, got)
        bms, by = bound_ms(nbytes, ops)
        ms = cuda_ms(lambda: kern(*args))
        dev_ms = device_ms(lambda: kern(*args))
        plain_ms = cuda_ms(lambda: plain(*args), reps=5, warmup=1)
        lib = library_call(name, args)
        lib_ms = cuda_ms(lib, reps=10, warmup=2) if lib is not None else None
        shape = list(args[0].shape)
        one = {"shape": shape, "max_abs_err": err, "ms": ms, "device_ms": dev_ms,
               "plain_ms": plain_ms,
               "bound_ms": bms, "bound_by": by, "bytes": nbytes, "ops": ops,
               "library_ms": lib_ms}
        if name == "fused_temperature":
            lab = k8_lab_only()
            one["lab_only_ms"] = cuda_ms(lambda: lab(*args))
            one["lab_only_device_ms"] = device_ms(lambda: lab(*args))
        if name == "gn_moments_euclidean" and isinstance(got, tuple):   # K4's loop
            one["iters"] = int(got[2])
        say("kernel", name=name, **one)
        row = rows.setdefault(name, {"name": name, "route": "cuda", "source": source,
                                     "replaces": replaces, "launches": 0,
                                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                                     "bound_ms": bms, "bound_by": by,
                                     "library_ms": lib_ms, "shapes": []})
        row["max_abs_err"] = max(row["max_abs_err"], err)
        if "lab_only_ms" in one and "lab_only_ms" not in row:
            row["lab_only_ms"] = one["lab_only_ms"]
        row["shapes"].append(one)
    return list(rows.values())


def record_launches(path: str, rows, launches, frames: int = 1) -> None:
    """Add one path's launch counts to the kernel rows (and, over a run of
    several frames, the count a frame); fail if a kernel of the path did not
    launch."""
    for row in rows:
        row[f"launches_{path}"] = launches[row["name"]]
        if frames > 1:
            row[f"launches_per_frame_{path}"] = launches[row["name"]] / frames
        row["launches"] += launches[row["name"]]
    for name in PATH_KERNELS[path]:
        assert launches[name] > 0, f"{name} was not launched on the {path} path"
    if path in PATH_EXACT_LAUNCHES:
        want = {k: PATH_EXACT_LAUNCHES[path].get(k, 0) * frames for k in launches}
        assert launches == want, f"{path} launches {launches}, expected {want}"


def same_alignment(args, ref, de, res, roi_from_finite: bool = False):
    """The port's CPU run of the pair given the card's alignment: the global
    shift is the card's, the CPU solves its own ECC from there (returned
    beside the result, to hold against the card's warp), and the stages
    after the ECC take the card's warp; ``roi_from_finite`` as the
    multimodal path calls the force.  Returns (result, (warp, rho,
    iterations) of the CPU's ECC, seconds)."""
    import torch
    import vistaf_torch.ftp.pipeline as ftp_pipeline
    from vistaf_torch.pipelines.force import ForcePipeline

    cpu = ForcePipeline(*args, debug_outputs=True, device="cpu")
    shift = torch.as_tensor(res["dbg_global_shift"])
    card_ecc = tuple(torch.as_tensor(res[k])
                     for k in ("dbg_ecc_warp", "dbg_ecc_rho", "dbg_ecc_iters"))
    own_ecc, solved = cpu.ftp._ecc, []

    def ecc(crop01):
        solved.append(own_ecc(crop01))
        return card_ecc

    cpu.ftp._ecc = ecc
    phase_correlate = ftp_pipeline.phase_correlate
    ftp_pipeline.phase_correlate = lambda a, b, win: (shift[0], shift[1], torch.zeros(()))
    try:
        t0 = time.perf_counter()
        out = cpu(ref, de, roi_from_finite=roi_from_finite)
        return out, solved[0], time.perf_counter() - t0
    finally:
        ftp_pipeline.phase_correlate = phase_correlate


def run_path(path: str, device, rows, cfg, h: int, w: int):
    """Drive ForcePipeline once on the card with the launch counts set to 0
    just before, check the path's kernels launched and the result against
    the port's CPU run (and, on the parity paths, against the CPU run given
    the card's alignment); returns a frame callable for timing."""
    import torch
    from vistaf_torch import kernels
    from vistaf_torch.config import ForceConfig
    from vistaf_torch.pipelines.force import ForcePipeline
    from vistaf_torch.utils.synthetic import synthetic_pair

    ref, de = synthetic_pair(h, w, cfg, seed=SEED)
    args = (cfg, ForceConfig(), P2H_MODEL, FORCE_MODEL)
    gpu = ForcePipeline(*args, debug_outputs=True, device=device)
    torch.cuda.synchronize()
    kernels.reset_launches()
    res = gpu(ref, de)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    record_launches(path, rows, launches)
    force = res["force_N"]
    assert np.isfinite(force) and force > 0.0, force
    hm = res["height_map_mm_crop"]
    roi = res["roi_eroded_crop"]
    assert hm.shape == roi.shape == (gpu.ftp.geom.crop_h, gpu.ftp.geom.crop_w)
    assert np.isfinite(hm[roi]).all()

    t0 = time.perf_counter()
    res_cpu = ForcePipeline(*args, debug_outputs=True, device="cpu")(ref, de)
    cpu_s = time.perf_counter() - t0
    gap = abs(force - res_cpu["force_N"]) / abs(res_cpu["force_N"])
    agree = float(np.mean(res["reliable_crop"] == res_cpu["reliable_crop"]))
    warp_gap = float(np.abs(res["dbg_ecc_warp"] - res_cpu["dbg_ecc_warp"])[:, 2].max())
    shift_gap = float(np.abs(res["dbg_global_shift"] - res_cpu["dbg_global_shift"]).max())
    say("end_to_end", path=path, force_N=force, force_N_cpu=res_cpu["force_N"],
        force_gap=gap, reliable_agreement=agree, ecc_warp_gap_px=warp_gap,
        ecc_warp=res["dbg_ecc_warp"].tolist(), ecc_warp_cpu=res_cpu["dbg_ecc_warp"].tolist(),
        ecc_iters=int(res["dbg_ecc_iters"]), ecc_iters_cpu=int(res_cpu["dbg_ecc_iters"]),
        global_shift=res["dbg_global_shift"].tolist(),
        global_shift_cpu=res_cpu["dbg_global_shift"].tolist(), global_shift_gap_px=shift_gap,
        gated=path not in ALIGNMENT_UNDETERMINED, cpu_seconds=cpu_s, launches=launches)
    if path in SAME_ALIGNMENT_PATHS:
        same, (warp_s, rho_s, it_s), same_s = same_alignment(args, ref, de, res)
        same_gap = abs(force - same["force_N"]) / abs(same["force_N"])
        same_warp_gap = float(np.abs(res["dbg_ecc_warp"] - warp_s.numpy())[:, 2].max())
        say("same_alignment", path=path, force_N=force, force_N_cpu=same["force_N"],
            force_gap=same_gap,
            reliable_agreement=float(np.mean(res["reliable_crop"] == same["reliable_crop"])),
            ecc_warp_cpu=warp_s.tolist(), ecc_rho=float(res["dbg_ecc_rho"]),
            ecc_rho_cpu=float(rho_s), ecc_iters_cpu=int(it_s), ecc_warp_gap_px=same_warp_gap,
            cpu_seconds=same_s)
        assert shift_gap <= SHIFT_ATOL_PX, shift_gap
        assert same_warp_gap < ECC_ATOL_PX, same_warp_gap
        assert same_gap <= FORCE_RTOL, (force, same["force_N"])
    if path not in ALIGNMENT_UNDETERMINED:
        assert gap <= FORCE_RTOL, (force, res_cpu["force_N"])
        assert warp_gap < ECC_ATOL_PX, warp_gap
    fast = ForcePipeline(*args, device=device)
    return fast, lambda: fast(ref, de)


def check_from_artifacts(device, cfg, h: int, w: int) -> None:
    """``ForcePipeline.from_artifacts`` over the two calibration JSONs of the
    reference layout, written to a temporary directory, against the
    pipeline built by its constructor from the same models, on the card and
    the same pair: the same force (within rel 1e-6)."""
    import os
    import tempfile
    from vistaf_torch.calib import artifacts
    from vistaf_torch.config import HEIGHT_TO_FORCE_JSON, PHASE_TO_HEIGHT_JSON, ForceConfig
    from vistaf_torch.pipelines.force import ForcePipeline
    from vistaf_torch.utils.synthetic import synthetic_pair

    ref, de = synthetic_pair(h, w, cfg, seed=SEED)
    built = ForcePipeline(cfg, ForceConfig(), P2H_MODEL, FORCE_MODEL, device=device)(ref, de)
    with tempfile.TemporaryDirectory() as root:
        artifacts.save_json(os.path.join(root, PHASE_TO_HEIGHT_JSON),
                            {"best_model": P2H_MODEL, "use_negated_height_for_fit": True})
        artifacts.save_json(os.path.join(root, HEIGHT_TO_FORCE_JSON),
                            {"best_model": FORCE_MODEL})
        loaded = ForcePipeline.from_artifacts(root, cfg, device=device)
    got = loaded(ref, de)
    gap = abs(got["force_N"] - built["force_N"]) / abs(built["force_N"])
    say("from_artifacts", force_N=got["force_N"], force_N_constructed=built["force_N"],
        force_gap=gap)
    assert loaded.force_model == FORCE_MODEL and loaded.ftp.p2h_model == P2H_MODEL
    assert gap <= 1e-6, (got["force_N"], built["force_N"])


def run_temperature(device, rows, cfg, path: str):
    """Drive TemperaturePipeline under ``cfg`` (TempConfig().deploy() on the
    ``temp4k`` path, TempConfig() on ``temp4k_parity``) once on the card at
    2160x3840 with the launch counts set to 0 just before, check the path's
    kernels launched and the result against the port's CPU run; returns the
    pipeline and the frame for timing."""
    import torch
    from vistaf_torch import kernels
    from vistaf_torch.temperature.inference import STATS, TemperaturePipeline
    from vistaf_torch.utils.synthetic import synthetic_deploy_temp_weights, synthetic_tlc_frame

    color, wide = synthetic_deploy_temp_weights(SEED)
    frame = synthetic_tlc_frame(H4K, W4K, cfg, SEED)
    gpu = TemperaturePipeline(cfg, color, wide, device=device)
    torch.cuda.synchronize()
    kernels.reset_launches()
    res = gpu(frame)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    record_launches(path, rows, launches)
    final = res["temperature_map_final"]
    roi = res["roi_outer"]
    assert final.shape == (H4K, W4K) and np.isfinite(final[roi]).mean() > 0.99
    st = gpu.stats(frame)
    for k in STATS:      # the same graph up to the stats; 1e-4 covers any reduction reorder
        assert abs(float(st[k]) - float(res[k])) <= 1e-4 * max(1.0, abs(float(res[k]))), \
            (k, st[k], res[k])

    t0 = time.perf_counter()
    res_cpu = TemperaturePipeline(cfg, color, wide, device="cpu")(frame)
    cpu_s = time.perf_counter() - t0
    gaps = {k: abs(float(res[k]) - float(res_cpu[k])) for k in ("t_mean", "t_min", "t_max")}
    valid_gap = abs(int(res["valid_pixels"]) - int(res_cpu["valid_pixels"])) \
        / int(res_cpu["valid_pixels"])
    color_share = float(np.mean(res["source_map"][roi] == 255))
    agree = {k: float(np.mean(res[k] == res_cpu[k]))
             for k in ("mask_dark", "mask_sat", "mask_color_support")}
    fa, fb = np.isfinite(final), np.isfinite(res_cpu["temperature_map_final"])
    both = fa & fb
    say("end_to_end", path=path, **{k: float(res[k]) for k in STATS},
        seg_peak_xy=res["seg_peak_xy"].tolist(), seg_peak_xy_cpu=res_cpu["seg_peak_xy"].tolist(),
        **{f"{k}_cpu": float(res_cpu[k]) for k in ("t_mean", "t_min", "t_max")},
        **{f"{k}_gap": v for k, v in gaps.items()}, valid_pixels_gap=valid_gap,
        color_share_of_roi=color_share, mask_agreement=agree,
        final_map_max_gap=float(np.abs(final[both] - res_cpu["temperature_map_final"][both]).max()),
        final_finite_agreement=float(np.mean(fa == fb)), cpu_seconds=cpu_s,
        compute_bbox=gpu._compute_bbox and list(gpu._compute_bbox), launches=launches)
    np.testing.assert_array_equal(res["seg_peak_xy"], res_cpu["seg_peak_xy"])
    assert gaps["t_mean"] <= T_MEAN_ATOL, gaps
    assert gaps["t_min"] <= T_EXTREME_ATOL and gaps["t_max"] <= T_EXTREME_ATOL, gaps
    assert valid_gap <= VALID_RTOL, valid_gap
    assert color_share >= COLOR_MIN_SHARE, color_share
    return gpu, frame


def compose_multimodal_frame(grating_bgr, tlc_bgr):
    """A frame of a skin that carries both patterns (neither
    ``synthetic_pair`` nor ``synthetic_tlc_frame`` draws both): the
    thermochromic frame's colour, each pixel's BGR minus its gray, over the
    grating frame's gray, rounded and clipped to uint8.  FTP locks on the
    grating carrier; the temperature path segments that grating as its
    stripes and reads the thermochromic colours on them."""
    t = tlc_bgr.astype(np.float32)
    lum = 0.114 * t[..., 0] + 0.587 * t[..., 1] + 0.299 * t[..., 2]
    g = grating_bgr[..., 0].astype(np.float32)
    return np.clip(np.round(t + (g - lum)[..., None]), 0, 255).astype(np.uint8)


def d2h_copies(fn):
    """(count, bytes) of the device-to-host copies one call of fn() makes,
    from torch.profiler's memcpy events (the trace's ``bytes``)."""
    import os
    import tempfile
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    copies = [e for e in events if e.get("cat") == "gpu_memcpy" and "DtoH" in e.get("name", "")]
    return len(copies), [int(e["args"]["bytes"]) for e in copies]


def run_multimodal(device, rows, force, temp, path: str, timed_force=None):
    """Drive MultimodalPipeline at 2160x3840 on the card over the 4K force
    and temperature pipelines built above (the deploy presets on the
    ``mm4k`` path, the parity presets on ``mm4k_parity``), on a frame pair
    that carries the grating and the thermochromic colours: ``__call__``
    (launches counted from 0 over that frame), then ``step_fused`` with both
    fetches, each held to its gates; the device-to-host copies of the scalar
    fetch; the port's CPU run of the same frames (on a parity path the force
    also given the card's alignment).  Returns (pipeline to time, ref, def):
    over ``timed_force`` where one is given."""
    import torch
    from vistaf_torch import kernels
    from vistaf_torch.config import ForceConfig
    from vistaf_torch.pipelines.force import ForcePipeline
    from vistaf_torch.pipelines.multimodal import MultimodalPipeline, temperature_stats
    from vistaf_torch.temperature.inference import TemperaturePipeline
    from vistaf_torch.utils.synthetic import (synthetic_deploy_temp_weights, synthetic_pair,
                                              synthetic_tlc_frame)

    fcfg, tcfg = force.ftp.cfg, temp.cfg
    ref_g, de_g = synthetic_pair(H4K, W4K, fcfg, seed=SEED)
    tlc = synthetic_tlc_frame(H4K, W4K, tcfg, SEED)
    ref, de = compose_multimodal_frame(ref_g, tlc), compose_multimodal_frame(de_g, tlc)
    del ref_g, de_g, tlc
    mm = MultimodalPipeline(force, temp)
    torch.cuda.synchronize()
    kernels.reset_launches()
    seq = mm(ref, de)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    record_launches(path, rows, launches)

    # the sequential path is the two pipelines alone, bit for bit
    de_t = mm.ingest(de)
    for k, v in force(ref, de_t, roi_from_finite=True).items():
        np.testing.assert_array_equal(seq["force"][k], v, err_msg=k)
    alone = temp(de_t)
    for k, v in alone.items():
        np.testing.assert_array_equal(seq["temperature"][k], v, err_msg=k)
    assert temperature_stats(alone, tcfg.crop_output_to_outer_roi) == seq["temperature_stats"]

    maps = mm.step_fused(ref, de_t, fetch="maps")
    kernels.reset_launches()
    sc = mm.step_fused(ref, de, fetch="scalars")
    torch.cuda.synchronize()
    launches_fused = dict(kernels.LAUNCHES)
    fs, ff = seq["force"], maps["force"]
    np.testing.assert_allclose(ff["height_map_mm_crop"], fs["height_map_mm_crop"],
                               rtol=MM_HEIGHT_RTOL, atol=MM_HEIGHT_ATOL, equal_nan=True)
    for k in ("volume_cm3", "contact_area_mm2", "max_depth_mm", "force_N", "mm_per_px",
              "estimated_grating_period_px"):
        assert abs(ff[k] - fs[k]) <= MM_SCALAR_REL * abs(fs[k]) + 1e-7, (k, ff[k], fs[k])
        assert abs(sc[k] - ff[k]) <= MM_FETCH_REL * abs(ff[k]) + 1e-9, (k, sc[k], ff[k])
    np.testing.assert_allclose(maps["temperature"]["temperature_map_final"],
                               seq["temperature"]["temperature_map_final"], rtol=1e-5,
                               atol=MM_TMAP_ATOL, equal_nan=True)
    st = maps["temperature_stats"]
    assert st["valid_pixels"] == seq["temperature_stats"]["valid_pixels"], st
    for k in ("mean_C", "median_C", "std_C", "min_C", "max_C"):
        assert abs(st[k] - seq["temperature_stats"][k]) <= MM_STATS_ATOL, (k, st)
    assert all(type(v) in (int, float) for v in sc.values()), sc
    assert sc["valid_pixels"] == st["valid_pixels"] > 0, (sc, st)
    for k in ("mean", "min", "max"):
        assert abs(sc[f"t_{k}_C"] - st[f"{k}_C"]) <= MM_STATS_ATOL, (k, sc, st)

    # the scalar fetch's own device-to-host traffic: one copy of the scalars
    ref_t = mm.ingest(ref)
    base_n, base_b = d2h_copies(lambda: mm.fused_forward(ref_t, de_t, stats_only=True))
    fetch_n, fetch_b = d2h_copies(lambda: mm.step_fused(ref_t, de_t, fetch="scalars"))
    extra_n, extra_b = fetch_n - base_n, sum(fetch_b) - sum(base_b)
    assert base_n > 0 and extra_n == 1 and extra_b == 8 * len(sc), (base_n, fetch_n, fetch_b)
    assert max(fetch_b) <= 8 * len(sc), fetch_b

    tres = seq["temperature"]
    color_share = float(np.mean(tres["source_map"][tres["roi_outer"]] == 255))
    t0 = time.perf_counter()
    color, wide = synthetic_deploy_temp_weights(SEED)
    cpu = MultimodalPipeline(
        ForcePipeline(fcfg, ForceConfig(), P2H_MODEL, FORCE_MODEL,
                      debug_outputs=force.ftp.debug_outputs, device="cpu"),
        TemperaturePipeline(tcfg, color, wide, device="cpu"))(ref, de)
    cpu_s = time.perf_counter() - t0
    cs, ts = cpu["temperature_stats"], seq["temperature_stats"]
    gaps = {"force": abs(fs["force_N"] - cpu["force"]["force_N"]) / abs(cpu["force"]["force_N"]),
            "t_mean": abs(ts["mean_C"] - cs["mean_C"]), "t_min": abs(ts["min_C"] - cs["min_C"]),
            "t_max": abs(ts["max_C"] - cs["max_C"]),
            "valid": abs(ts["valid_pixels"] - cs["valid_pixels"]) / cs["valid_pixels"]}
    say("end_to_end", path=path, force_N=fs["force_N"], force_N_cpu=cpu["force"]["force_N"],
        ecc_warp=fs["dbg_ecc_warp"].tolist() if "dbg_ecc_warp" in fs else None,
        temperature_stats=ts, temperature_stats_cpu=cs, gaps=gaps,
        color_share_of_roi=color_share, scalars=sc, cpu_seconds=cpu_s,
        d2h_copies_forward=base_n, d2h_copies_scalars=fetch_n,
        d2h_bytes_scalars_fetch=extra_b, d2h_bytes_scalars_step=sum(fetch_b),
        launches=launches, launches_fused_scalars=launches_fused,
        gated=path not in ALIGNMENT_UNDETERMINED)
    assert np.isfinite(fs["force_N"]) and fs["force_N"] > 0.0, fs["force_N"]
    if path in SAME_ALIGNMENT_PATHS:
        args = (fcfg, ForceConfig(), P2H_MODEL, FORCE_MODEL)
        same, (warp_s, rho_s, it_s), same_s = same_alignment(args, ref, de, fs,
                                                             roi_from_finite=True)
        shift_gap = float(np.abs(fs["dbg_global_shift"]
                                 - cpu["force"]["dbg_global_shift"]).max())
        same_gap = abs(fs["force_N"] - same["force_N"]) / abs(same["force_N"])
        same_warp_gap = float(np.abs(fs["dbg_ecc_warp"] - warp_s.numpy())[:, 2].max())
        say("same_alignment", path=path, force_N=fs["force_N"], force_N_cpu=same["force_N"],
            force_gap=same_gap, global_shift_gap_px=shift_gap, ecc_warp_cpu=warp_s.tolist(),
            ecc_warp=fs["dbg_ecc_warp"].tolist(), ecc_iters=int(fs["dbg_ecc_iters"]),
            ecc_iters_cpu=int(it_s), ecc_warp_gap_px=same_warp_gap, cpu_seconds=same_s)
        assert shift_gap <= SHIFT_ATOL_PX, shift_gap
        assert same_warp_gap < ECC_ATOL_PX, same_warp_gap
        assert same_gap <= FORCE_RTOL, (fs["force_N"], same["force_N"])
    if path not in ALIGNMENT_UNDETERMINED:
        assert gaps["force"] <= FORCE_RTOL, gaps
    assert gaps["t_mean"] <= T_MEAN_ATOL, gaps
    assert gaps["t_min"] <= T_EXTREME_ATOL and gaps["t_max"] <= T_EXTREME_ATOL, gaps
    assert gaps["valid"] <= VALID_RTOL, gaps
    assert ts["valid_pixels"] > 0 and color_share >= COLOR_MIN_SHARE, (ts, color_share)
    for name in PATH_KERNELS[path]:
        assert launches_fused[name] > 0, f"{name} was not launched by step_fused"
    if path in PATH_EXACT_LAUNCHES:
        want = {k: PATH_EXACT_LAUNCHES[path].get(k, 0) for k in launches_fused}
        assert launches_fused == want, (launches_fused, want)
    if timed_force is not None:
        mm = MultimodalPipeline(timed_force, temp)
    return mm, ref, de


def run_streams(device, rows, card):
    """Drive StreamingForce over BatchedForce at 640x480 on the card: four
    streams, window 8, EMA 0.2, a sequence of BATCHES batches through
    ``run_overlapped`` (launches counted from 0 over it), held bit for bit
    to the serialized calls, each stream to ``_single`` and the smoothing
    to the port's CPU ``update``; then timed."""
    import torch
    from vistaf_torch import kernels
    from vistaf_torch.config import slice_ftp_config
    from vistaf_torch.ftp.pipeline import FTPPipeline
    from vistaf_torch.parallel.mesh import BatchedForce
    from vistaf_torch.pipelines.streaming import StreamingForce, init_state, update
    from vistaf_torch.utils.synthetic import synthetic_pair

    cfg = slice_ftp_config(H, W)
    refs = np.stack([synthetic_pair(H, W, cfg, seed=SEED + s)[0] for s in range(STREAMS)])
    seq = [np.stack([synthetic_pair(H, W, cfg, seed=SEED + s,
                                    dent_depth_rad=DENTS_RAD[(s + t) % len(DENTS_RAD)])[1]
                     for s in range(STREAMS)]) for t in range(BATCHES)]
    bf = BatchedForce(FTPPipeline(cfg, P2H_MODEL, device=device), FORCE_MODEL)
    sf = StreamingForce(bf, STREAMS, window=WINDOW, ema_alpha=EMA_ALPHA)
    torch.cuda.synchronize()
    kernels.reset_launches()
    over = sf.run_overlapped(refs, seq)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    record_launches("streams640", rows, launches, frames=BATCHES * STREAMS)

    serial_sf = StreamingForce(bf, STREAMS, window=WINDOW, ema_alpha=EMA_ALPHA)
    serial = [serial_sf(refs, b) for b in seq]
    state = init_state(STREAMS, WINDOW, device="cpu")
    for o, s in zip(over, serial):
        for k in o:
            np.testing.assert_array_equal(o[k], s[k], err_msg=k)
        state, ref_out = update(state, torch.as_tensor(o["force_raw_N"]), EMA_ALPHA)
        for k, v in ref_out.items():
            np.testing.assert_array_equal(o[k], v.numpy(), err_msg=k)
    out = bf.batched()(refs, seq[0])
    for s in range(STREAMS):
        one = bf._single(refs[s], seq[0][s])
        for k in ("force_N", "max_depth_mm"):
            assert torch.equal(out[k][s], one[k]), (k, s, out[k], one[k])
    np.testing.assert_array_equal(over[0]["force_raw_N"], out["force_N"].cpu().numpy())

    # timing: each batch alone (CUDA events, 2 warm-up), then whole
    # sequences on the host's clock, serialized and overlapped in turns
    times = []
    for b in seq[:2] + seq:
        a, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        serial_sf(refs, b)
        e.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(e))
    walls = {"serialized": [], "overlapped": []}
    for kind in ("serialized", "overlapped", "overlapped", "serialized"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if kind == "serialized":
            for b in seq:
                serial_sf(refs, b)
        else:
            sf.run_overlapped(refs, seq)
        walls[kind].append(time.perf_counter() - t0)
    p50 = float(np.percentile(times[2:], 50))
    say("end_to_end", path="streams640", streams=STREAMS, window=WINDOW, batches=BATCHES,
        force_raw_N=[o["force_raw_N"].tolist() for o in over],
        force_median_N=[o["force_median_N"].tolist() for o in over],
        in_contact=[o["in_contact"].tolist() for o in over], launches=launches,
        launches_per_stream_frame={k: v / (BATCHES * STREAMS) for k, v in launches.items()})
    say("timing", path="streams640", batches_timed=len(times) - 2,
        p50_ms_per_batch=p50, p90_ms_per_batch=float(np.percentile(times[2:], 90)),
        fps=1000.0 * STREAMS / p50,
        sequence_ms_per_batch={k: [1e3 * w / BATCHES for w in v] for k, v in walls.items()},
        sequence_fps={k: [STREAMS * BATCHES / w for w in v] for k, v in walls.items()},
        card=card)
    assert all(np.isfinite(o["force_raw_N"]).all() for o in over)
    return lambda: sf(refs, seq[0])


def phase_timing(path, fn, card, frames: int, warmup: int):
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(frames):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    # every host sync of one frame, as PyTorch's sync debug mode reports them
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    syncs = sum("synchroniz" in str(w.message) for w in caught)
    p50 = float(np.percentile(times, 50))
    p90 = float(np.percentile(times, 90))
    say("timing", path=path, frames=frames, p50_ms=p50, p90_ms=p90, fps=1000.0 / p50,
        host_syncs_per_frame=syncs, card=card)


def phase_profile(path, fn, frames: int):
    """Device busy share of a steady window: the kernels' self device time
    (``torch.profiler``) over the window's wall time, profiler on, and the
    kernels that take the most of it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(frames):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / frames
    averages = prof.key_averages()
    # device-side events only (kernels, copies): host ops report their
    # kernels' time too and would count it twice
    events = [e for e in averages
              if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3 / frames
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:10]
    launches = sum(e.count for e in averages if e.key == "cudaLaunchKernel")
    # cooperative and cluster launches (K4, K5, K6) are counted apart
    special = sum(e.count for e in averages
                  if e.key in ("cudaLaunchCooperativeKernel", "cudaLaunchKernelExC"))
    # the hand-written kernels (csrc/*.cu keeps each in an anonymous namespace)
    ours = [[e.key.split("(")[1].split("::")[-1] if e.key.startswith("(anon") else e.key[:60],
             e.self_device_time_total / 1e3 / frames, e.count / frames]
            for e in events if e.key.startswith("(anonymous namespace)")]
    say("profile", path=path, frames=frames, wall_ms_per_frame=wall_ms,
        device_busy_ms_per_frame=busy_ms, device_busy_share=busy_ms / wall_ms,
        cuda_launches_per_frame=launches / frames,
        cooperative_or_cluster_launches_per_frame=special / frames,
        top=[[e.key[:60], e.self_device_time_total / 1e3 / frames, e.count / frames]
             for e in top],
        hand_written=ours)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from vistaf_torch import kernels, use_full_fp32
    card = card_line()
    say("device", card=card, torch=torch.__version__, cuda=torch.version.cuda)
    use_full_fp32()
    t0 = time.perf_counter()
    so = kernels.build()
    kernels.library()
    say("build", seconds=time.perf_counter() - t0, library=so.name)

    from vistaf_torch.config import FTPConfig, TempConfig, slice_ftp_config
    from vistaf_torch.utils.synthetic import scaled_ftp_config
    device = torch.device("cuda", 0)
    clock = {"build": time.perf_counter() - t0}

    def lap(name):
        clock[name] = time.perf_counter() - t0 - sum(clock.values())

    rows = phase_kernels(device)
    lap("kernels")
    runs = {"640": run_path("640", device, rows, slice_ftp_config(H, W), H, W)[1]}
    force4k, runs["4k"] = run_path("4k", device, rows, FTPConfig().deploy(), H4K, W4K)
    temp, frame = run_temperature(device, rows, TempConfig().deploy(), "temp4k")
    runs["temp4k"] = lambda: temp(frame)
    runs["temp4k_stats"] = lambda: temp.stats(frame)
    lap("end_to_end")
    mm, mm_ref, mm_def = run_multimodal(device, rows, force4k, temp, "mm4k")
    runs["mm4k"] = lambda: mm(mm_ref, mm_def)
    runs["mm4k_scalars"] = lambda: mm.step_fused(mm_ref, mm_def, fetch="scalars")
    lap("mm4k")
    runs["streams640"] = run_streams(device, rows, card)
    lap("streams640")
    runs["parity640"] = run_path("parity640", device, rows, scaled_ftp_config(H, W), H, W)[1]
    check_from_artifacts(device, scaled_ftp_config(H, W), H, W)
    force_p4k, runs["parity4k"] = run_path("parity4k", device, rows, FTPConfig(), H4K, W4K)
    lap("parity")
    temp_p, frame_p = run_temperature(device, rows, TempConfig(), "temp4k_parity")
    dep, par = temp.stats(frame_p), temp_p.stats(frame_p)
    say("parity_vs_deploy", path="temp4k_parity", gated=False,
        **{f"{k}_gap": float(par[k]) - float(dep[k]) for k in ("t_mean", "t_min", "t_max")},
        valid_pixels=int(par["valid_pixels"]), valid_pixels_deploy=int(dep["valid_pixels"]))
    runs["temp4k_parity"] = lambda: temp_p(frame_p)
    runs["temp4k_parity_stats"] = lambda: temp_p.stats(frame_p)
    lap("temp4k_parity")
    from vistaf_torch.config import ForceConfig
    from vistaf_torch.pipelines.force import ForcePipeline
    debug_p4k = ForcePipeline(FTPConfig(), ForceConfig(), P2H_MODEL, FORCE_MODEL,
                              debug_outputs=True, device=device)
    mmp, mmp_ref, mmp_def = run_multimodal(device, rows, debug_p4k, temp_p, "mm4k_parity",
                                           timed_force=force_p4k)
    runs["mm4k_parity"] = lambda: mmp(mmp_ref, mmp_def)
    runs["mm4k_parity_scalars"] = lambda: mmp.step_fused(mmp_ref, mmp_def, fetch="scalars")
    lap("mm4k_parity")
    phase_timing("640", runs["640"], card, frames=20, warmup=3)
    phase_timing("4k", runs["4k"], card, frames=5, warmup=2)
    phase_timing("temp4k", runs["temp4k"], card, frames=6, warmup=2)
    phase_timing("temp4k_stats", runs["temp4k_stats"], card, frames=6, warmup=2)
    phase_timing("mm4k", runs["mm4k"], card, frames=5, warmup=2)
    phase_timing("mm4k_scalars", runs["mm4k_scalars"], card, frames=5, warmup=2)
    phase_timing("parity640", runs["parity640"], card, frames=10, warmup=2)
    phase_timing("parity4k", runs["parity4k"], card, frames=3, warmup=1)
    phase_timing("temp4k_parity", runs["temp4k_parity"], card, frames=3, warmup=1)
    phase_timing("temp4k_parity_stats", runs["temp4k_parity_stats"], card, frames=3, warmup=1)
    phase_timing("mm4k_parity", runs["mm4k_parity"], card, frames=3, warmup=1)
    phase_timing("mm4k_parity_scalars", runs["mm4k_parity_scalars"], card, frames=3, warmup=1)
    lap("timing")
    phase_profile("640", runs["640"], frames=5)
    phase_profile("4k", runs["4k"], frames=2)
    phase_profile("temp4k_stats", runs["temp4k_stats"], frames=3)
    phase_profile("mm4k_scalars", runs["mm4k_scalars"], frames=2)
    phase_profile("streams640", runs["streams640"], frames=2)
    phase_profile("parity640", runs["parity640"], frames=2)
    phase_profile("parity4k", runs["parity4k"], frames=1)
    phase_profile("temp4k_parity_stats", runs["temp4k_parity_stats"], frames=1)
    phase_profile("mm4k_parity_scalars", runs["mm4k_parity_scalars"], frames=1)
    lap("profile")
    say("clock", seconds=clock, total=time.perf_counter() - t0)

    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
