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
  8a. BASELINE config 5 at 640x480 (phase ``limb640``): the same four
     streams (their first batch) through ``whole_limb_step`` and
     ``whole_limb_step_aux`` (map stride 2, a 960x1280 canvas, the poses of
     scripts/bench_streams.py, one stream's gate 0 and one's 0.5) on a
     world-1 NCCL stream mesh; a stream frame launches exactly what a
     streams640 frame launches (K1 7, K3 1, K5 1, K6 1, K7 2); the forces
     bit-equal to ``BatchedForce.batched()``, the aux head's to them times
     the gates, the gates within 1e-6 of ``motion_gate``, the sums within
     1e-6, the maps the heightmaps' contact depth and the canvas a numpy
     max-blend of them; against the same heads on the port's CPU (a gloo
     mesh) the forces, map maxima and canvas maximum within 1%; p50 and p90
     a step, the step rate, the fusion alone and the NCCL version;
     then the force path under ``scaled_ftp_config(480, 640)`` with
     ``percentile_method="hist"`` (phase ``hist640``): K3 exactly twice a
     frame and no other kernel, the parity gates below;
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
     each path under torch.profiler;
  11. runner at 2160x3840 (``vistaf_torch/runner``): the ``force`` command
     whole through ``cli.main`` under ``--preset parity`` and ``deploy``
     (with ``--export-heightmaps``) on the 4K pair written as lossless PNGs
     with the calibration JSONs to a temporary data root, and ``run_session``
     over the multimodal pipelines built above (parity sequential, deploy
     ``fused_step``) on the composed pair: the force equal to the
     constructor-built pipeline's direct call within rel 1e-6 and its
     heightmap bit-equal, the session's readings, maps and mask PNGs equal
     to the direct call, the JAX runner's file sets, the exact launches of
     the kernel table, each command's wall time split by ``StageTimer``
     (setup, decode, forward, writers); a probe line says whether
     matplotlib, joblib and sklearn are present, and where they are the
     phase also runs ``force --debug`` and ``temperature``;
  12. trainers at 2160x3840 (``vistaf_torch/trainers``), on seeded series
     written as JPEGs to a temporary directory: ``train-p2h`` through
     ``cli.main`` on the four calibration indentations (K3 exactly 1 a
     frame, no other kernel; the first minimum within 1e-3 of the port's
     CPU run given the card's alignment) and ``train-h2f`` on the ten
     loading frames with the p2h model just written (K3 exactly 2 a frame;
     each row's volume bit-equal to ``ForcePipeline``'s; a second run
     resumes, launches nothing and writes the same model JSON); the
     temperature trainers (7 temperatures x 2 frames a run, the real
     annulus, degrees, CV splits, Huber constants and 4000 px an image) on
     the card and on the port's CPU (the same degrees, metrics within 1e-6,
     each final fit that reached a minimizer, within its 500 rounds and
     with its scale above the 1e-10 floor, with the same rounds, weights
     within 1e-7 and objective within 1e-8; the others reported); the
     black trainer's global fit at its real
     sample count (1.44 M, degree 3), timed, against the CPU fit (the same
     iterations, weights within 1e-6); the trained global models through
     ``TemperaturePipeline`` under both presets (K1 1, K3 2, K8 1 and K3 2
     a frame) against the CPU under the deploy contract; ``pretest``
     through ``cli.main`` on a settling series of 30 frames (the CPU's
     stabilization index, mean L within 1e-3).  Each trainer's file set is
     checked (figures recorded where matplotlib is missing), and its wall
     time split into setup, decode, forward_fit and writers;
  13. knobs (``KNOBS_4K``, ``KNOBS_640``): the FTPConfig knobs off the
     presets' path through ForcePipeline, each with its exact launches
     (``KNOB_LAUNCHES``).  At 2160x3840 ``takeda4k`` (FTPConfig() with the
     Gaussian sideband, the unlocked per-frame demod and its dk ramp, the
     translation ECC on the stride-2 gather grid), ``window4k``
     (FTPConfig() with the Hann window, no DC removal, the affine ECC) and
     ``prealign4k`` (FTPConfig().deploy() with the grating-band
     prealignment and the single-pass detrend; K1, K2, K3, K4), each held to
     the port's CPU run given the card's alignment (its prealignment warp
     too): force within 1%, the CPU's own ECC and prealignment solves
     within 0.05 px of the card's unless ``ALIGNMENT_UNDETERMINED`` names
     them; at 640x480 ``prealign640`` (the deploy preset with the
     prealignment, whose ECC is K4's loop) and the nine knobs alone on the
     parity preset (``knob_*``), each held to the free-running CPU run
     (force 1%, ECC 0.05 px); then timing and profile lines for the 4K
     paths and prealign640.
Every end-to-end path also prints a ``jax`` line beside its ``end_to_end``
line (``hold_*_to_jax``): its inputs must hash to the JAX package's record
(tests/fixtures/, scripts/make_jax_record.py), and the card's run is held to
that record free-running and, on the force, knob and multimodal paths, in a
second card forward given JAX's global shift, ECC and prealignment warps,
with the gates of ``JAX_UNDETERMINED``'s comment.
Then the card line, one JSON line with the kernel table and, last, the
device line.
"""
from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import tempfile
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
# (``same_alignment``), and the solves the synthetic scene leaves
# undetermined on a path, which are then reported, not gated: 'free', the
# free-running comparison; 'ecc', the crop ECC's warp (free-running, and the
# CPU's own solve given the card's shift); 'prealign', the CPU's own
# prealignment solve given the card's warps.  On the native-4K synthetic
# pair the parity ECC's ty is not determined to ECC_ATOL_PX (the vertical
# grating leaves it nearly flat, and a 0.003 px change of the global shift
# moves the CPU's own stop from 15 to 19-23 iterations and ty by 0.1-0.2
# px), so the card's and the CPU's global shifts, ~0.006 px apart, end 0.4
# px apart in ty and 3.6% apart in force (x17 through the 4K growth model).
# cv2's translation ECC at 640x480 (knob_translation) has no rotation to
# hold ty either: the card stopped after 20 iterations at ty 0.1691 px, the
# CPU after 13 at 0.1082, 0.061 px apart, force 0.018% apart.  Its affine
# ECC (knob_affine) diverges along y, which the grating does not fix (in
# the JAX package too, tests/test_torch_knobs.py): a11 150 and ty -17470
# px on the card, -17663 px on the CPU, after 73 and 80 iterations, force
# 15.6% apart free-running (measured on an NVIDIA H100 80GB HBM3, 700.00 W)
SAME_ALIGNMENT_PATHS = ("parity640", "hist640", "parity4k", "mm4k_parity", "takeda4k",
                        "window4k", "prealign4k", "knob_affine")
ALIGNMENT_UNDETERMINED = {"parity4k": ("free",), "mm4k_parity": ("free",),
                          "knob_translation": ("ecc",), "knob_affine": ("free", "ecc")}
# the JAX package's results on every end-to-end path (the record under
# tests/fixtures/ that scripts/make_jax_record.py writes, on a CPU): each
# path's ``jax`` line holds the card's run to it free-running (force 1%, ECC
# 0.05 px, equal carrier bins and seg peak, boolean maps agreeing on
# RELIABLE_MIN of the pixels, the temperature contract) and, on the force
# paths, a second card run given JAX's alignment (force 1%, the card's own
# ECC and prealignment solves from JAX's shift within 0.05 px).  The solves
# the synthetic scene leaves undetermined against JAX, named as in
# ALIGNMENT_UNDETERMINED, are reported there, not gated.  Measured on an
# NVIDIA H100 80GB HBM3, 700.00 W: on the native-4K pair the whitened phase
# correlation's y, like the ECC's ty, is nearly flat, and the card's global
# shift lands 0.012 px from JAX's (the port's CPU 0.014 px); under deploy
# (``4k``) the ECC then stops 0.0019 px from JAX's, the volume 0.058% and
# the force 1.05% apart (x18 through the growth model), and given JAX's
# shift the card's own ECC lands 1.0e-4 px from JAX's warp and the force
# 0.027%.  The parity gather ECC (``parity4k``) stops 0.24 px from JAX's
# free-running (force 0.21%) and 0.61 px from JAX's shift (17 iterations
# against 40; force 6.4e-5 given JAX's warp).  The translation ECC on the
# stride-2 gather grid (``takeda4k``) stops 0.0023 px from JAX's
# free-running but 0.35 px from JAX's shift (5 iterations against 19;
# force 0.12% free, 0.032% given).  The affine ECC (``window4k``) walks off
# along y on both sides: 25.5 px from JAX's free-running (11 iterations
# against 36, force 20.6% apart), 28.0 px from JAX's shift; given JAX's
# warp the force is 0.0105% apart.  On the multimodal parity pair
# (``mm4k_parity``) the shift lands 0.0094 px from JAX's and the ECC,
# after the same 4 iterations, 0.0089 px: the volume 0.088% and the force
# 1.54% apart free-running, 2.8e-5 given JAX's alignment
RECORD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "fixtures")
RELIABLE_MIN = 0.995
JAX_UNDETERMINED = {"4k": ("free",), "parity4k": ("ecc",), "takeda4k": ("ecc",),
                    "window4k": ("free", "ecc"), "mm4k_parity": ("free",)}
JAX_PATHS = ("640", "parity640", "hist640", "4k", "parity4k", "temp4k", "temp4k_parity", "mm4k",
             "mm4k_parity", "takeda4k", "window4k", "prealign4k", "prealign640", "streams640",
             "limb640")
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
    "limb640": ("masked_quantiles", "inpaint_diffusion", "ecc_loop_euclidean", "unwrap_wls",
                "robust_polyfit2d"),
    "parity640": ("inpaint_diffusion",),
    "hist640": ("inpaint_diffusion",),
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
                       "hist640": {"inpaint_diffusion": 2},
                       "parity4k": {"inpaint_diffusion": 2},
                       "temp4k_parity": {"inpaint_diffusion": 2},
                       "mm4k_parity": {"inpaint_diffusion": 4}}
# the runner phase: each command's or session's whole launch count at
# 2160x3840, the CLI's presets (PERF.md's kernel table: the 4K force, 4K
# multimodal and their parity columns)
RUNNER_LAUNCHES = {
    "cli_force_parity": {"inpaint_diffusion": 2},
    "cli_force_deploy": {"masked_quantiles": 7, "masked_median_mad": 4,
                         "inpaint_diffusion": 1, "gn_moments_euclidean": 1},
    "session_parity": {"inpaint_diffusion": 4},
    "session_deploy": {"masked_quantiles": 8, "masked_median_mad": 4, "inpaint_diffusion": 3,
                       "gn_moments_euclidean": 1, "fused_temperature": 1},
}
PATH_KERNELS.update({k: tuple(v) for k, v in RUNNER_LAUNCHES.items()})
PATH_EXACT_LAUNCHES.update(RUNNER_LAUNCHES)
# the knobs phase: the FTPConfig knobs off the presets' path.  At 2160x3840
# three combinations, each on its base preset: the classical FTP route (the
# Gaussian sideband, the unlocked carrier with its dk ramp, cv2's
# translation ECC on the strided gather grid), the Hann window without the
# DC removal under the affine ECC, and the grating-band prealignment with
# the single-pass detrend under deploy
KNOBS_4K = {
    "takeda4k": (False, dict(sideband_method="gauss", lock_carrier_to_reference=False,
                             ecc_warp_mode="translation", ecc_stride=2)),
    "window4k": (False, dict(use_hann_window=True, remove_mean_after_apod=False,
                             ecc_warp_mode="affine")),
    "prealign4k": (True, dict(use_grating_band_prealign=True, use_two_pass_detrend=False)),
}
# at 640x480 each knob alone on the parity preset (scaled_ftp_config)
KNOBS_640 = {
    "knob_gauss": dict(sideband_method="gauss"),
    "knob_unlocked": dict(lock_carrier_to_reference=False),
    "knob_hann": dict(use_hann_window=True),
    "knob_no_dc": dict(remove_mean_after_apod=False),
    "knob_translation": dict(ecc_warp_mode="translation"),
    "knob_affine": dict(ecc_warp_mode="affine"),
    "knob_stride2": dict(ecc_stride=2),
    "knob_single_pass": dict(use_two_pass_detrend=False),
    "knob_prealign": dict(use_grating_band_prealign=True),
}
# each knob path's whole launch count a frame, from the code.  Parity: K3 in
# each demod call (two one-frame calls unlocked, one pair call more for the
# prealignment's pass-1 demod) and in the hole fill.  prealign4k: the 4K
# deploy frame (K1 7, K2 4, K3 1, K4 1 for the coarse ECC) plus the pass-1
# demod (K1 2, K3 1), its reliable mask (K1 1) and the high-pass
# percentiles (K1 2), the prealignment's ECC on the host above K4's budget,
# and the single-pass detrend: the plane fit no longer folded (K2 2), the
# quadratic fit (K2 2), its median (K1 1), where the two-pass detrend took
# K2 4 and K1 2.  prealign640: the 640 deploy frame (K1 7, K3 1, K5 1, K6 1,
# K7 2) plus the pass-1 demod and mask and the high-pass (K1 5, K3 1) and
# the prealignment's ECC, K4's loop (loop_kernel=False, as JAX calls it)
KNOB_LAUNCHES = {
    "takeda4k": {"inpaint_diffusion": 3},
    "window4k": {"inpaint_diffusion": 2},
    "prealign4k": {"masked_quantiles": 11, "masked_median_mad": 4, "inpaint_diffusion": 2,
                   "gn_moments_euclidean": 1},
    "prealign640": {"masked_quantiles": 12, "inpaint_diffusion": 2, "gn_moments_euclidean": 1,
                    "ecc_loop_euclidean": 1, "unwrap_wls": 1, "robust_polyfit2d": 2},
    **{k: {"inpaint_diffusion": 3 if k in ("knob_unlocked", "knob_prealign") else 2}
       for k in KNOBS_640},
}
PATH_KERNELS.update({k: tuple(v) for k, v in KNOB_LAUNCHES.items()})
PATH_EXACT_LAUNCHES.update(KNOB_LAUNCHES)
# the trainers phase at 2160x3840: the p2h indentations (the four
# DEFAULT_CALIBRATION_SAMPLES), the h2f loading frames (sphere-{1 + 5k}.jpg,
# the first frame of each of the first ten force levels: the trainer's
# minimum of 10 rows), the temperature trainers' 7 temperatures x 2 frames a
# run (the real series: 27 or 36 x 5), the pretest's settling series, and
# the black trainer's real global fit size (36 temperatures x 5 frames x
# 4000 px x 2 runs = 1.44 M samples, degree 3)
P2H_DENTS_RAD = (0.4, 0.6, 0.8, 1.0)
H2F_DENTS_RAD = tuple(0.1 * (k + 1) for k in range(10))
TRAIN_TEMPS, TRAIN_FRAMES = tuple(range(20, 27)), 2
PRETEST_LEVELS = tuple(20.0 + 6.0 * (1.0 - np.exp(-i / 4.0)) for i in range(30))
HUBER_TEMPS, HUBER_FRAMES, HUBER_PX, HUBER_DEGREE = tuple(range(20, 56)), 5, 4000, 3
# each trainer's whole launch count a frame: K3 in the p2h variant's demod
# only (its hole fill is off), in the demod and the hole fill of h2f's
# parity forward; none on a resumed h2f run and in the temperature trainers
# and the pretest (cv2 LAB, masked means, Huber fits, the unfused LAB); the
# trained models served through TemperaturePipeline as on temp4k (deploy)
# and temp4k_parity
TRAINER_LAUNCHES = {
    "train_p2h": {"inpaint_diffusion": 1}, "train_h2f": {"inpaint_diffusion": 2},
    "train_h2f_resume": {}, "train_temp_color": {}, "train_temp_black": {}, "pretest": {},
    "roundtrip_deploy": {"masked_quantiles": 1, "inpaint_diffusion": 2,
                         "fused_temperature": 1},
    "roundtrip_parity": {"inpaint_diffusion": 2},
}
PATH_KERNELS.update({k: tuple(v) for k, v in TRAINER_LAUNCHES.items()})
PATH_EXACT_LAUNCHES.update(TRAINER_LAUNCHES)
# the trainers' gates against the port's CPU run: p2h's first minimum given
# the card's alignment; the temperature trainers' degrees and metrics, and
# each final fit that met its stop within the round cap: the same rounds,
# its weights (the determined coefficients relative to the largest, coef[0]
# + intercept relative, the split between them, which rounding sets,
# absolute: calib/huber.py) and its Huber objective.  A fit the cap stopped
# (500 rounds, the JAX trainer's cap), or whose scale a Newton step threw
# onto its 1e-10 floor, where the scale loop can no longer move it, has
# reached no minimizer, and rounding decides which run does that: its gaps
# are reported, not held (ROADMAP Queue 3 items 3 and 4).  The 1.44
# M-sample fit's rounds and weights; the pretest's mean L
TRAINER_MIN_RTOL, TRAINER_METRIC_ATOL, TRAINER_COEF_RTOL = 1e-3, 1e-6, 1e-7
TRAINER_OBJECTIVE_RTOL, HUBER_MAX_ROUNDS, HUBER_SIGMA_FLOOR = 1e-8, 500, 1e-10
HUBER_COEF_RTOL, SPLIT_ATOL, MEAN_L_ATOL = 1e-6, 1e-4, 1e-3
# each trainer's file set, as the JAX trainers write it (tests/
# test_torch_trainers_{force,temp}.py hold these to the JAX trainers'
# outputs); the temperature trainers also write three .npz, and three
# .joblib where joblib and sklearn are present, named by the chosen degrees
P2H_FILES = ("calibration_model.json", "calibration_results.csv", "calibration_plot.png")
H2F_FILES = ("calibration_model.json", "per_image_results.csv", "per_image_results.jsonl",
             "volume_by_force_boxplot.png", "force_vs_volume_fit.png")
COLOR_TRAINER_FILES = (
    "00_roi_overlay.png", "01_heating_L_vs_T_modelcurve.png",
    "02_cooling_L_vs_T_modelcurve.png", "03_hysteresis_L_vs_T_models.png",
    "05_global_true_vs_pred.png", "06_global_L_vs_T_all_trend.png",
    "07_global_per_temp_error.csv", "08_global_mae_vs_T.png",
    "models_final_summary_metrics.json", "equations_color_models_final.txt")
BLACK_TRAINER_FILES = (
    "00_roi_overlay.png", "01_heating_gray_vs_T_modelcurve.png",
    "02_cooling_gray_vs_T_modelcurve.png", "03_hysteresis_gray_vs_T_models.png",
    "05_global_true_vs_pred.png", "06_global_gray_vs_T_all_modelcurve.png",
    "models_final_summary_metrics.json", "equations_black_models_final.txt")
# the figure writers of vistaf_torch.trainers.plots and the files each call
# writes (its first argument: an output directory or a file path)
FIGURE_WRITERS = {
    "save_h2f_plots": ("volume_by_force_boxplot.png", "force_vs_volume_fit.png"),
    "save_p2h_plot": ("calibration_plot.png",),
    "save_annulus_roi_overlay": None, "plot_feat_vs_T_run": None, "plot_hysteresis": None,
    "plot_true_vs_pred": None, "plot_feat_vs_T_all": None, "plot_per_temp_mae": None,
    "save_pretest_figure": None,
}
# the multimodal gates of tests/test_multimodal_fused.py: step_fused(maps)
# against __call__, step_fused(scalars) against step_fused(maps)
MM_HEIGHT_RTOL, MM_HEIGHT_ATOL, MM_SCALAR_REL = 1e-5, 1e-6, 1e-4
MM_TMAP_ATOL, MM_STATS_ATOL, MM_FETCH_REL = 1e-4, 1e-3, 1e-6
# BASELINE config 4 (scripts/bench_streams.py): 4 streams, window 8, EMA 0.2
STREAMS, WINDOW, EMA_ALPHA, BATCHES = 4, 8, 0.2, 6
DENTS_RAD = (0.8, 0.0, 0.5, 0.3, 0.7, 0.1)
# BASELINE config 5 (scripts/bench_streams.py): the whole-limb heads over the
# 4 streams at map stride 2, the aux head on a (2H, 2W) canvas; a stream
# frame launches what a streams640 frame launches (PERF.md's kernel table),
# the heads add no kernel of the table
LIMB_STRIDE, LIMB_CANVAS = 2, (2 * H, 2 * W)
PATH_EXACT_LAUNCHES["limb640"] = {"masked_quantiles": 7, "inpaint_diffusion": 1,
                                  "ecc_loop_euclidean": 1, "unwrap_wls": 1,
                                  "robust_polyfit2d": 2}
# the runner's file contract without figures (matplotlib), as the JAX runner
# writes it (tests/test_torch_runner.py and tests/test_torch_cli.py hold
# these to the JAX trees): the force command with --export-heightmaps, and
# one multimodal session (save_summary_figures=False)
FORCE_CLI_FILES = ("result.json", "result.csv", "ftp_run/height_map_crop.npy",
                   "ftp_run/height_map_crop.csv", "ftp_run/height_map_bundle.npz")
# each mask PNG of a temperature output and the output key it is cropped from
MASK_KEYS = {"mask_roi.png": "roi_full", "mask_roi_eff.png": "mask_roi_eff",
             "mask_sat.png": "mask_sat", "mask_dark.png": "mask_dark",
             "mask_light.png": "mask_light", "mask_color_support.png": "mask_color_support",
             "mask_color_ok.png": "mask_color_ok"}
MASK_PNGS = tuple(MASK_KEYS)
# the FTP debug set the force command's --debug adds under ftp_run/ (the JAX
# contract, tests/test_debug_artifacts.py)
FTP_DEBUG_FILES = (
    "debug_log.txt", "DEBUG_fft_peaks_ref.png", "DEBUG_fft_peaks_def.png",
    "DEBUG_complex_amplitude_ref.png", "DEBUG_complex_amplitude_def.png",
    "DEBUG_phase_wrapped_ref.png", "DEBUG_phase_wrapped_def.png",
    "DEBUG_phase_unwrapped_ref.png", "DEBUG_phase_unwrapped_def.png",
    "DEBUG_ramp_phase_diff.png", "DEBUG_ramp_cross_phase_diff.png",
    "DEBUG_phase_diff_wrapped.png", "03_ref_def_crops_with_roi.png", "05_fft_debug_panels.png",
    "07_phase_and_height_FINAL_SMOOTH_ROI.png")
SESSION_FILES = (
    "force_sensing/result.json", "force_sensing/result.csv",
    "force_sensing/ftp_run/height_map_crop.npy", "force_sensing/ftp_run/height_map_full.npy",
    "force_sensing/ftp_run/height_map_crop.csv", "force_sensing/ftp_run/height_map_bundle.npz",
    "temperature_sensing/temperature_map_fused.npy",
    "temperature_sensing/temperature_map_final.npy",
    *(f"temperature_sensing/{m}" for m in MASK_PNGS),
    "combined_outputs/multimodal_summary.json", "combined_outputs/force_result.json",
    "combined_outputs/force_result.csv")


def input_digest(a) -> str:
    """sha256 of an input array's dtype, shape and bytes: the key by which
    the JAX record (scripts/make_jax_record.py) and a run here know that
    they saw the same input."""
    import hashlib
    a = np.ascontiguousarray(a)
    h = hashlib.sha256(f"{a.dtype.str}{a.shape}".encode())
    h.update(a.tobytes())
    return h.hexdigest()


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


def same_alignment(args, ref, de, res, roi_from_finite: bool = False, prealign=None):
    """The port's CPU run of the pair given the card's alignment ``res``
    (with debug outputs) and prealignment warp ``prealign``: ``given_alignment``
    on the CPU."""
    return given_alignment(args, ref, de, res, "cpu", roi_from_finite, prealign)


def given_alignment(args, ref, de, align, device, roi_from_finite: bool = False,
                    prealign=None):
    """ForcePipeline on ``device`` over the pair given an alignment: the
    global shift is ``align``'s ``dbg_global_shift``, the run solves its own
    ECC from there (returned beside the result, to hold against the given
    warp), and the stages after the ECC take ``align``'s ``dbg_ecc_warp``
    (with its rho and iterations); so does a prealignment, given the warp
    ``prealign`` (its own solve appended to the returned ECC tuple), or
    solves its own where ``prealign`` is None; ``roi_from_finite`` as the
    multimodal path calls the force.  ``align`` holds arrays (a run's debug
    outputs) or lists (the JAX record).
    Returns (result, (warp, rho, iterations[, prealignment warp]) of the
    run's own solves on the CPU, seconds)."""
    import torch
    import vistaf_torch.ftp.pipeline as ftp_pipeline
    from vistaf_torch.pipelines.force import ForcePipeline

    def t(v, dtype=torch.float32):
        if isinstance(v, torch.Tensor):
            return v.to(device=device, dtype=dtype)
        return torch.as_tensor(np.asarray(v), dtype=dtype, device=device)

    pipe = ForcePipeline(*args, debug_outputs=True, device=device)
    shift = t(align["dbg_global_shift"])
    given_ecc = (t(align["dbg_ecc_warp"]), t(align["dbg_ecc_rho"]),
                 t(align["dbg_ecc_iters"], torch.int32))
    own_ecc, own_prealign, solved = pipe.ftp._ecc, pipe.ftp._prealign_ecc, []

    def ecc(crop01):
        solved.append(own_ecc(crop01))
        return given_ecc

    def prealign_ecc(hp_pair, mask):
        solved.append(own_prealign(hp_pair, mask))
        return t(prealign)

    pipe.ftp._ecc = ecc
    if prealign is not None:
        pipe.ftp._prealign_ecc = prealign_ecc
    phase_correlate = ftp_pipeline.phase_correlate
    ftp_pipeline.phase_correlate = lambda a, b, win: (shift[0], shift[1],
                                                      torch.zeros((), device=device))
    try:
        t0 = time.perf_counter()
        out = pipe(ref, de, roi_from_finite=roi_from_finite)
        own = solved[0] + ((solved[1],) if prealign is not None else ())
        return out, tuple(x.cpu() for x in own), time.perf_counter() - t0
    finally:
        ftp_pipeline.phase_correlate = phase_correlate


def capture_prealign(pipe):
    """A list that receives each prealignment warp ``pipe`` solves."""
    warps, own = [], pipe.ftp._prealign_ecc
    pipe.ftp._prealign_ecc = lambda *a: warps.append(own(*a)) or warps[-1]
    return warps


_RECORD = {}
JAX_SECONDS = {}     # the seconds each path's jax line took (the clock line's ``jax``)


def jax_timed(fn):
    """``fn`` with its wall time added to JAX_SECONDS under its path (its
    first argument, or its name)."""
    import functools

    @functools.wraps(fn)
    def timed(*a, **k):
        t0 = time.perf_counter()
        try:
            return fn(*a, **k)
        finally:
            key = a[0] if isinstance(a[0], str) else fn.__name__
            JAX_SECONDS[key] = JAX_SECONDS.get(key, 0.0) + time.perf_counter() - t0
    return timed


def jax_record():
    """(the JAX record's paths, a function (path, name) -> one of its
    boolean maps)."""
    if not _RECORD:
        with open(os.path.join(RECORD_DIR, "jax_record.json")) as f:
            rec = json.load(f)
        with np.load(os.path.join(RECORD_DIR, rec["maps"])) as z:
            _RECORD.update(paths=rec["paths"], packed=dict(z))
    paths, packed = _RECORD["paths"], _RECORD["packed"]

    def bool_map(path, name):
        shape = paths[path]["maps"][name]
        bits = np.unpackbits(packed[f"{path}/{name}"], count=int(np.prod(shape)))
        return bits.astype(bool).reshape(shape)
    return paths, bool_map


def model_arrays(models):
    """Each array of the temperature models under ``name.field``: inputs
    the JAX record hashes."""
    import dataclasses
    return {f"{m.name}.{k}": v for m in models for k, v in dataclasses.asdict(m).items()
            if isinstance(v, np.ndarray)}


def check_jax_inputs(path: str, **arrays) -> None:
    """Fail unless every input of the path hashes to the JAX record's: a
    changed scene must not be compared with another scene's record."""
    want = jax_record()[0][path]["inputs"]
    assert set(arrays) == set(want), (path, sorted(arrays), sorted(want))
    for k, v in arrays.items():
        assert input_digest(v) == want[k], f"{path}: input {k} is not the JAX record's"


def rel_gap(a, b) -> float:
    return abs(float(a) - float(b)) / abs(float(b))


def warp_gap_px(a, b) -> float:
    """The largest translation gap of two 2x3 warps."""
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))[:, 2].max())


def force_gaps(res, rec, reliable):
    """A force result's gaps to the JAX record's result ``rec`` (its
    reliable mask ``reliable``)."""
    return dict(
        force_gap=rel_gap(res["force_N"], rec["force_N"]),
        volume_gap=rel_gap(res["volume_cm3"], rec["volume_cm3"]),
        ecc_warp_gap_px=warp_gap_px(res["dbg_ecc_warp"], rec["dbg_ecc_warp"]),
        global_shift_gap_px=float(np.abs(np.asarray(res["dbg_global_shift"], np.float64)
                                         - rec["dbg_global_shift"]).max()),
        carrier_bins_equal=all(
            np.array_equal(np.round(np.asarray(res[k], np.float64)), np.round(rec[k]))
            for k in ("carrier_k_ref", "carrier_k_def", "dbg_peak_ref")),
        reliable_agreement=float(np.mean(np.asarray(res["reliable_crop"]) == reliable)),
        ecc_iters=int(res["dbg_ecc_iters"]), ecc_iters_jax=int(rec["dbg_ecc_iters"]))


@jax_timed
def hold_force_to_jax(path: str, args, ref, de, res, device, prealign=None,
                      roi_from_finite: bool = False, inputs=None, undetermined=None):
    """The ``jax`` line of a force path: ``res`` (a run on ``device`` with
    debug outputs; ``prealign`` its prealignment warp) against the JAX
    record free-running, and a second run on ``device`` given JAX's
    alignment (``given_alignment``): its force within 1%, its own ECC and
    prealignment solves within 0.05 px of JAX's warps.  Free-running: equal
    carrier bins, reliable masks agreeing on RELIABLE_MIN, force within 1%,
    the ECC (and prealignment) within 0.05 px.  What JAX_UNDETERMINED names
    is reported, not gated: 'free' the free-running force, 'ecc' the ECC
    solves (free-running and the run's own from JAX's shift), 'prealign'
    the prealignment's; volume gaps are reported beside the force gaps.
    ``inputs``: the path's other inputs, hashed with the pair;
    ``undetermined``: the names for this run, JAX_UNDETERMINED's (the
    card's) by default.  Returns the line."""
    paths, bool_map = jax_record()
    rec = paths[path]["result"]
    if undetermined is None:
        undetermined = JAX_UNDETERMINED.get(path, ())
    check_jax_inputs(path, **{"ref": ref, "def": de}, **(inputs or {}))
    reliable = bool_map(path, "reliable_crop")
    free = force_gaps(res, rec, reliable)
    jax_prealign = rec["prealign_warp"]
    if jax_prealign is not None:
        free["prealign_warp_gap_px"] = warp_gap_px(prealign.cpu(), jax_prealign)
    given, own, seconds = given_alignment(args, ref, de, rec, device, roi_from_finite,
                                          jax_prealign)
    same = dict(force_gap=rel_gap(given["force_N"], rec["force_N"]),
                volume_gap=rel_gap(given["volume_cm3"], rec["volume_cm3"]),
                reliable_agreement=float(np.mean(given["reliable_crop"] == reliable)),
                own_ecc_gap_px=warp_gap_px(own[0], rec["dbg_ecc_warp"]),
                own_ecc_iters=int(own[2]), seconds=seconds)
    if jax_prealign is not None:
        same["own_prealign_gap_px"] = warp_gap_px(own[3], jax_prealign)
    line = dict(path=path, force_N=float(res["force_N"]), force_N_jax=rec["force_N"],
                volume_cm3=float(res["volume_cm3"]), volume_cm3_jax=rec["volume_cm3"],
                ecc_warp_jax=rec["dbg_ecc_warp"], prealign_warp_jax=jax_prealign,
                free=free, given_alignment=same, undetermined=list(undetermined))
    say("jax", **line)
    assert same["force_gap"] <= FORCE_RTOL, (path, same)
    if "ecc" not in undetermined:
        assert same["own_ecc_gap_px"] < ECC_ATOL_PX, (path, same)
    if "prealign" not in undetermined:
        assert same.get("own_prealign_gap_px", 0.0) < ECC_ATOL_PX, (path, same)
    assert free["carrier_bins_equal"] and free["reliable_agreement"] >= RELIABLE_MIN, \
        (path, free)
    if "free" not in undetermined:
        assert free["force_gap"] <= FORCE_RTOL, (path, free)
    if "ecc" not in undetermined:
        assert free["ecc_warp_gap_px"] < ECC_ATOL_PX, (path, free)
    if "prealign" not in undetermined:
        assert free.get("prealign_warp_gap_px", 0.0) < ECC_ATOL_PX, (path, free)
    return line


def temperature_gaps(res, rec, stats=None):
    """A temperature result's gaps to the JAX record's ``rec``: the scene
    scalars of ``res`` (``stats``, the multimodal path's temperature stats,
    where given)."""
    if stats is None:
        got = {k: float(res[k]) for k in ("t_mean", "t_min", "t_max")}
        want = {k: rec[k] for k in got}
        valid, valid_jax = int(res["valid_pixels"]), int(rec["valid_pixels"])
    else:
        keys = {"t_mean": "mean_C", "t_min": "min_C", "t_max": "max_C"}
        got = {k: float(stats[v]) for k, v in keys.items()}
        want = {k: rec["stats"][v] for k, v in keys.items()}
        valid, valid_jax = int(stats["valid_pixels"]), int(rec["stats"]["valid_pixels"])
    gaps = {f"{k}_gap": abs(got[k] - want[k]) for k in got}
    gaps.update(valid_pixels_gap=abs(valid - valid_jax) / valid_jax,
                seg_peak_equal=bool(np.array_equal(res["seg_peak_xy"], rec["seg_peak_xy"])))
    return {**{f"{k}_jax": v for k, v in want.items()}, **gaps}


TEMP_MASKS = ("mask_dark", "mask_light", "mask_sat", "mask_roi_eff", "mask_color_support",
              "mask_color_ok")


@jax_timed
def hold_temperature_to_jax(path: str, res, frame=None, stats=None, models=None,
                            scalars=None, undetermined=None):
    """The ``jax`` line of a temperature path (``frame`` and ``models``, its
    inputs, hashed against the record), or of the temperature half of a
    multimodal path (``stats``; ``scalars``, the run's
    ``step_fused(scalars)``, beside JAX's): equal seg peak, t_mean within
    0.1 degC, t_min and t_max within 0.75 degC, valid pixels within 0.5%,
    each mask agreeing on RELIABLE_MIN; the scalars' force within 1% unless
    ``undetermined`` (JAX_UNDETERMINED's by default) names 'free'.  Returns
    the line."""
    paths, bool_map = jax_record()
    rec = paths[path]["result"]
    if stats is not None:
        rec = rec["temperature"]
    if frame is not None:
        check_jax_inputs(path, frame=frame, **model_arrays(models))
    gaps = temperature_gaps(res, rec, stats)
    agree = {k: float(np.mean(np.asarray(res[k]) == bool_map(path, k))) for k in TEMP_MASKS}
    line = dict(path=path, modality="temperature", **gaps, mask_agreement=agree)
    if scalars is not None:
        want = paths[path]["result"]["scalars"]
        line["scalars_gap"] = {
            "force": rel_gap(scalars["force_N"], want["force_N"]),
            "volume": rel_gap(scalars["volume_cm3"], want["volume_cm3"]),
            **{k: abs(scalars[f"{k}_C"] - want[f"{k}_C"]) for k in ("t_mean", "t_min", "t_max")},
            "valid": abs(scalars["valid_pixels"] - want["valid_pixels"]) / want["valid_pixels"]}
    say("jax", **line)
    assert gaps["seg_peak_equal"], (path, gaps)
    assert gaps["t_mean_gap"] <= T_MEAN_ATOL, (path, gaps)
    assert gaps["t_min_gap"] <= T_EXTREME_ATOL and gaps["t_max_gap"] <= T_EXTREME_ATOL, \
        (path, gaps)
    assert gaps["valid_pixels_gap"] <= VALID_RTOL, (path, gaps)
    assert min(agree.values()) >= RELIABLE_MIN, (path, agree)
    if undetermined is None:
        undetermined = JAX_UNDETERMINED.get(path, ())
    if scalars is not None:
        sg = line["scalars_gap"]
        if "free" not in undetermined:
            assert sg["force"] <= FORCE_RTOL, (path, sg)
        assert sg["t_mean"] <= T_MEAN_ATOL and sg["valid"] <= VALID_RTOL, (path, sg)
        assert sg["t_min"] <= T_EXTREME_ATOL and sg["t_max"] <= T_EXTREME_ATOL, (path, sg)
    return line


# the streams' and the limb heads' outputs held to JAX within 1%
# (``contract_gap``) free-running: the forces and their smoothing, the
# contact areas and the motion gates.  Their depth maxima (a stream's
# deepest pixel, the limb maps' and the canvas' maxima) are reported: at
# 640x480 they sit on the crop's top edge, where the free-running ECC's
# flat ty moves them (the streams of seeds 2 and 3 end 0.92 and 0.86 px
# from JAX in ty on the CPU, their deepest pixels 4.4% and 2.5% apart; given
# JAX's alignment, within 2e-5)
STREAM_KEYS = ("force_raw_N", "force_median_N", "force_mean_N", "force_ema_N", "total_force_N")
LIMB_KEYS = ("per_stream_force", "total_force_N", "contact_area_mm2")


@jax_timed
def hold_streams_to_jax(refs, seq, outs):
    """The ``jax`` line of streams640: each batch's outputs against the JAX
    StreamingForce's, the forces within 1% (``contract_gap``), the contact
    states equal, the depth maxima's gap reported.  Returns the line."""
    check_jax_inputs("streams640", refs=refs, **{f"batch{t}": b for t, b in enumerate(seq)})
    rec = jax_record()[0]["streams640"]["result"]

    def gap(k):
        return max(float(contract_gap(o[k], r).max()) for o, r in zip(outs, rec[k]))
    gaps = {k: gap(k) for k in STREAM_KEYS}
    contact = all(np.array_equal(o["in_contact"], r) for o, r in zip(outs, rec["in_contact"]))
    line = dict(path="streams640", gaps=gaps, in_contact_equal=contact,
                reported={"max_depth_mm": gap("max_depth_mm")},
                force_raw_N_jax=rec["force_raw_N"])
    say("jax", **line)
    assert max(gaps.values()) <= FORCE_RTOL and contact, line
    return line


@jax_timed
def hold_limb_to_jax(inputs, got, got_aux):
    """The ``jax`` line of limb640: both heads' outputs (numpy) against the
    JAX heads', the forces, sums, areas and gates within 1%
    (``contract_gap``), the contact maps agreeing on RELIABLE_MIN, the depth
    maxima's gaps reported.  Returns the line."""
    refs, defs, (pose, accel) = inputs
    check_jax_inputs("limb640", refs=refs, defs=defs, pose=pose, accel=accel)
    paths, bool_map = jax_record()
    rec = paths["limb640"]["result"]
    limb = got["whole_limb_map_mm"]
    gaps = {k: float(contract_gap(got[k], rec[k]).max()) for k in LIMB_KEYS}
    gaps.update({f"aux_{k}": float(contract_gap(got_aux[k], rec["aux"][k]).max())
                 for k in LIMB_KEYS + ("stream_gate",)})
    reported = {
        "max_depth_mm": float(contract_gap(got["max_depth_mm"], rec["max_depth_mm"]).max()),
        "map_max": float(contract_gap(limb.max(axis=(1, 2)), rec["map_max"]).max()),
        "aux_canvas_max": float(contract_gap(got_aux["limb_canvas_mm"].max(),
                                             rec["aux"]["canvas_max"]).max())}
    agree = float(np.mean((limb > 0) == bool_map("limb640", "contact")))
    line = dict(path="limb640", gaps=gaps, reported=reported, contact_agreement=agree,
                per_stream_force_jax=rec["per_stream_force"])
    say("jax", **line)
    assert max(gaps.values()) <= FORCE_RTOL and agree >= RELIABLE_MIN, line
    return line


def run_path(path: str, device, rows, cfg, h: int, w: int, free_cpu: bool = True):
    """Drive ForcePipeline once on the card with the launch counts set to 0
    just before, check the path's kernels launched and the result against
    the port's CPU run (with ``free_cpu``) and, on the paths of
    ``SAME_ALIGNMENT_PATHS``, against the CPU run given the card's
    alignment; returns a frame callable for timing."""
    import torch
    from vistaf_torch import kernels
    from vistaf_torch.config import ForceConfig
    from vistaf_torch.pipelines.force import ForcePipeline
    from vistaf_torch.utils.synthetic import synthetic_pair

    ref, de = synthetic_pair(h, w, cfg, seed=SEED)
    args = (cfg, ForceConfig(), P2H_MODEL, FORCE_MODEL)
    gpu = ForcePipeline(*args, debug_outputs=True, device=device)
    prealign = capture_prealign(gpu)   # the card's prealignment warp, for the CPU given it
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

    line = dict(path=path, force_N=force, ecc_warp=res["dbg_ecc_warp"].tolist(),
                ecc_iters=int(res["dbg_ecc_iters"]),
                global_shift=res["dbg_global_shift"].tolist(), launches=launches)
    if prealign:
        line["prealign_warp"] = prealign[0].tolist()
    gap = warp_gap = None
    if free_cpu:
        t0 = time.perf_counter()
        res_cpu = ForcePipeline(*args, debug_outputs=True, device="cpu")(ref, de)
        gap = abs(force - res_cpu["force_N"]) / abs(res_cpu["force_N"])
        warp_gap = float(np.abs(res["dbg_ecc_warp"] - res_cpu["dbg_ecc_warp"])[:, 2].max())
        line.update(
            force_N_cpu=res_cpu["force_N"], force_gap=gap,
            reliable_agreement=float(np.mean(res["reliable_crop"] == res_cpu["reliable_crop"])),
            ecc_warp_gap_px=warp_gap, ecc_warp_cpu=res_cpu["dbg_ecc_warp"].tolist(),
            ecc_iters_cpu=int(res_cpu["dbg_ecc_iters"]),
            global_shift_cpu=res_cpu["dbg_global_shift"].tolist(),
            global_shift_gap_px=float(np.abs(res["dbg_global_shift"]
                                             - res_cpu["dbg_global_shift"]).max()),
            undetermined=list(ALIGNMENT_UNDETERMINED.get(path, ())),
            cpu_seconds=time.perf_counter() - t0)
    say("end_to_end", **line)
    undetermined = ALIGNMENT_UNDETERMINED.get(path, ())
    if path in SAME_ALIGNMENT_PATHS:
        same, own, same_s = same_alignment(args, ref, de, res,
                                           prealign=prealign[0] if prealign else None)
        same_gap = abs(force - same["force_N"]) / abs(same["force_N"])
        same_warp_gap = float(np.abs(res["dbg_ecc_warp"] - own[0].numpy())[:, 2].max())
        extra = {}
        if prealign:
            extra = dict(prealign_warp_cpu=own[3].tolist(), prealign_warp_gap_px=float(
                np.abs(prealign[0].cpu().numpy() - own[3].numpy())[:, 2].max()))
        say("same_alignment", path=path, force_N=force, force_N_cpu=same["force_N"],
            force_gap=same_gap,
            reliable_agreement=float(np.mean(res["reliable_crop"] == same["reliable_crop"])),
            ecc_warp_cpu=own[0].tolist(), ecc_rho=float(res["dbg_ecc_rho"]),
            ecc_rho_cpu=float(own[1]), ecc_iters_cpu=int(own[2]),
            ecc_warp_gap_px=same_warp_gap, undetermined=list(undetermined),
            cpu_seconds=same_s, **extra)
        if free_cpu:
            assert line["global_shift_gap_px"] <= SHIFT_ATOL_PX, line["global_shift_gap_px"]
        assert same_gap <= FORCE_RTOL, (force, same["force_N"])
        if "ecc" not in undetermined:
            assert same_warp_gap < ECC_ATOL_PX, same_warp_gap
        if "prealign" not in undetermined:
            assert extra.get("prealign_warp_gap_px", 0.0) < ECC_ATOL_PX, extra
    if free_cpu and "free" not in undetermined:
        assert gap <= FORCE_RTOL, (force, res_cpu["force_N"])
        if "ecc" not in undetermined:
            assert warp_gap < ECC_ATOL_PX, warp_gap
    if path in jax_record()[0]:
        hold_force_to_jax(path, args, ref, de, res, device, prealign[0] if prealign else None)
    fast = ForcePipeline(*args, device=device)
    return fast, lambda: fast(ref, de)


def force_path_configs():
    """Each ForcePipeline path's preset and frame size (height, width), as
    the phases drive them: BASELINE config 1 (``640``), the parity presets,
    ``hist`` at 640x480, the native-4K deploy preset and the knob paths."""
    from vistaf_torch.config import FTPConfig, slice_ftp_config
    from vistaf_torch.utils.synthetic import scaled_ftp_config
    paths = {"640": (slice_ftp_config(H, W), H, W),
             "hist640": (scaled_ftp_config(H, W).replace(percentile_method="hist"), H, W),
             "parity640": (scaled_ftp_config(H, W), H, W),
             "4k": (FTPConfig().deploy(), H4K, W4K), "parity4k": (FTPConfig(), H4K, W4K)}
    for path, (deploy, change) in KNOBS_4K.items():
        base = FTPConfig().deploy() if deploy else FTPConfig()
        paths[path] = (base.replace(**change), H4K, W4K)
    paths["prealign640"] = (slice_ftp_config(H, W).replace(use_grating_band_prealign=True), H, W)
    for path, change in KNOBS_640.items():
        paths[path] = (scaled_ftp_config(H, W).replace(**change), H, W)
    return paths


def run_knobs(device, rows, card):
    """The knobs phase: the three 2160x3840 knob combinations of
    ``KNOBS_4K`` (held to the CPU run given the card's alignment), the 640
    deploy preset with the prealignment (``prealign640``) and each knob of
    ``KNOBS_640`` alone on the 640 parity preset (both held to the
    free-running CPU run), each with its exact launches; then the 4K paths
    and prealign640 timed and profiled."""
    cfgs = force_path_configs()
    runs = {}
    for path in KNOBS_4K:
        runs[path] = run_path(path, device, rows, *cfgs[path], free_cpu=False)[1]
    runs["prealign640"] = run_path("prealign640", device, rows, *cfgs["prealign640"])[1]
    for path in KNOBS_640:
        run_path(path, device, rows, *cfgs[path])
    for path, fn in runs.items():
        big = path.endswith("4k")
        phase_timing(path, fn, card, frames=3 if big else 10, warmup=1 if big else 2)
        phase_profile(path, fn, frames=1 if big else 2)


def check_from_artifacts(device, cfg, h: int, w: int) -> None:
    """``ForcePipeline.from_artifacts`` over the two calibration JSONs of the
    reference layout, written to a temporary directory, against the
    pipeline built by its constructor from the same models, on the card and
    the same pair: the same force (within rel 1e-6)."""
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
    hold_temperature_to_jax(path, res, frame=frame, models=(color, wide))
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


def multimodal_inputs(fcfg, tcfg):
    """The multimodal pair at 2160x3840: ``synthetic_pair`` under the force
    preset composed with ``synthetic_tlc_frame`` under the temperature
    preset."""
    from vistaf_torch.utils.synthetic import synthetic_pair, synthetic_tlc_frame
    ref_g, de_g = synthetic_pair(H4K, W4K, fcfg, seed=SEED)
    tlc = synthetic_tlc_frame(H4K, W4K, tcfg, SEED)
    return compose_multimodal_frame(ref_g, tlc), compose_multimodal_frame(de_g, tlc)


def d2h_copies(fn):
    """(count, bytes) of the device-to-host copies one call of fn() makes,
    from torch.profiler's memcpy events (the trace's ``bytes``)."""
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
    from vistaf_torch.utils.synthetic import synthetic_deploy_temp_weights

    fcfg, tcfg = force.ftp.cfg, temp.cfg
    ref, de = multimodal_inputs(fcfg, tcfg)
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
        ecc_warp=fs["dbg_ecc_warp"].tolist(),
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
    hold_force_to_jax(path, (fcfg, ForceConfig(), P2H_MODEL, FORCE_MODEL), ref, de, fs, device,
                      roi_from_finite=True, inputs=model_arrays((color, wide)))
    hold_temperature_to_jax(path, tres, stats=ts, scalars=sc)
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
    from vistaf_torch.ftp.pipeline import FTPPipeline
    from vistaf_torch.parallel.mesh import BatchedForce
    from vistaf_torch.pipelines.streaming import StreamingForce, init_state, update

    cfg, refs, seq = stream_inputs()
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
    hold_streams_to_jax(refs, seq, over)
    return lambda: sf(refs, seq[0])


def contract_gap(card, cpu):
    """|card - cpu| relative to |cpu|, and to the largest |cpu| where the
    CPU reads 0 (a stream with no pixel over the contact threshold), per
    element."""
    card, cpu = np.asarray(card, np.float64), np.asarray(cpu, np.float64)
    scale = np.where(cpu != 0.0, np.abs(cpu), np.abs(cpu).max())
    return np.abs(card - cpu) / scale


def max_blend(maps, gates, poses, canvas_hw, stride):
    """numpy model of the aux head's canvas: each map times its gate,
    max-blended onto zeros at its pose // stride clipped to keep it inside."""
    ch, cw = canvas_hw[0] // stride, canvas_hw[1] // stride
    ph, pw = maps.shape[1:]
    canvas = np.zeros((ch, cw), np.float32)
    for mp, g, (y, x) in zip(maps, gates, poses):
        y, x = min(max(y // stride, 0), ch - ph), min(max(x // stride, 0), cw - pw)
        canvas[y:y + ph, x:x + pw] = np.maximum(canvas[y:y + ph, x:x + pw], mp * g)
    return canvas


class _Replay:
    """Per-stream results computed before, handed out in stream order: the
    whole-limb heads over it time the fusion alone."""

    def __init__(self, outs, depth_eps_mm):
        self.outs, self.depth_eps_mm, self.k = outs, depth_eps_mm, 0

    def _single(self, ref, de):
        self.k += 1
        return self.outs[(self.k - 1) % len(self.outs)]


def run_limb(device, rows, card):
    """BASELINE config 5 at 640x480 on the card: the four streams of
    ``run_streams`` (their first batch) through ``whole_limb_step`` and
    ``whole_limb_step_aux`` on a world-1 NCCL stream mesh (launches counted
    from 0 over both), held to ``BatchedForce.batched()`` on the same card,
    to ``motion_gate`` and a numpy max-blend, and to the same heads on the
    port's CPU (a gloo mesh) within the deploy contract's 1%; then timed,
    the fusion alone too.  Returns the two steps for the profile."""
    import torch
    import torch.distributed as dist
    from vistaf_torch import kernels
    from vistaf_torch.ftp.pipeline import FTPPipeline
    from vistaf_torch.parallel import (BatchedForce, make_stream_mesh, motion_gate, shard_batch,
                                       whole_limb_step, whole_limb_step_aux)

    cfg, refs, defs, (pose, accel) = limb_inputs()
    mesh = make_stream_mesh()
    assert dist.get_backend() == "nccl" and mesh.size() == 1 and mesh.device_type == "cuda"
    bf = BatchedForce(FTPPipeline(cfg, P2H_MODEL, device=device), FORCE_MODEL)
    step = whole_limb_step(bf, mesh, map_stride=LIMB_STRIDE)
    step_aux = whole_limb_step_aux(bf, mesh, LIMB_CANVAS, map_stride=LIMB_STRIDE)
    rs, ds = shard_batch(mesh, refs), shard_batch(mesh, defs)
    aux = {"pose_px": shard_batch(mesh, pose), "accel_mss": shard_batch(mesh, accel)}
    torch.cuda.synchronize()
    kernels.reset_launches()
    out = step(rs, ds)
    out_aux = step_aux(rs, ds, aux)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    record_launches("limb640", rows, launches, frames=2 * STREAMS)

    got = {k: v.cpu().numpy() for k, v in out.items()}
    got_aux = {k: v.cpu().numpy() for k, v in out_aux.items()}
    ref = bf.batched()(rs, ds)
    forces = ref["force_N"]
    gates = out_aux["stream_gate"]
    assert torch.equal(out["per_stream_force"], forces), (out["per_stream_force"], forces)
    assert torch.equal(out_aux["per_stream_force"], forces * gates)
    gate_gap = float((gates.cpu() - motion_gate(torch.as_tensor(accel))).abs().max())
    assert gate_gap <= 1e-6, gate_gap
    for o in (got, got_aux):
        total = float(o["per_stream_force"].astype(np.float64).sum())
        assert abs(float(o["total_force_N"]) - total) <= 1e-6 * abs(total), o
    limb = got["whole_limb_map_mm"]
    assert limb.shape == (STREAMS, 118, 118), limb.shape
    hm = ref["height_map_mm"].cpu().numpy()
    hmf = np.where(np.isfinite(hm), hm, 0.0).astype(np.float32)
    neg = np.clip(-hmf, 0, None).sum(axis=(1, 2)) > np.clip(hmf, 0, None).sum(axis=(1, 2))
    depth = np.where(neg[:, None, None], -hmf, hmf)
    want_map = np.where(np.isfinite(hm) & (depth > bf.depth_eps_mm), depth, 0.0)
    np.testing.assert_array_equal(limb, want_map[:, ::LIMB_STRIDE, ::LIMB_STRIDE])
    canvas = got_aux["limb_canvas_mm"]
    np.testing.assert_array_equal(
        canvas, max_blend(limb, got_aux["stream_gate"], pose, LIMB_CANVAS, LIMB_STRIDE))

    # the same heads on the port's CPU (a gloo group over the same rank)
    t0 = time.perf_counter()
    cpu_mesh = make_stream_mesh(device="cpu")
    cpu_bf = BatchedForce(FTPPipeline(cfg, P2H_MODEL, device="cpu"), FORCE_MODEL)
    cpu = {k: v.numpy() for k, v in whole_limb_step(
        cpu_bf, cpu_mesh, map_stride=LIMB_STRIDE)(refs, defs).items()}
    cpu_aux = {k: v.numpy() for k, v in whole_limb_step_aux(
        cpu_bf, cpu_mesh, LIMB_CANVAS, map_stride=LIMB_STRIDE)(
            refs, defs, {"pose_px": pose, "accel_mss": accel}).items()}
    cpu_s = time.perf_counter() - t0
    gaps = {
        "per_stream_force": contract_gap(got["per_stream_force"], cpu["per_stream_force"]),
        "map_max": contract_gap(limb.max(axis=(1, 2)), cpu["whole_limb_map_mm"].max(axis=(1, 2))),
        "aux_per_stream_force": contract_gap(got_aux["per_stream_force"],
                                             cpu_aux["per_stream_force"]),
        "canvas_max": contract_gap(canvas.max(), cpu_aux["limb_canvas_mm"].max()),
        "total_force_N": contract_gap(got["total_force_N"], cpu["total_force_N"]),
    }
    say("end_to_end", path="limb640", streams=STREAMS, map_stride=LIMB_STRIDE,
        canvas=list(canvas.shape), pose_px=pose.tolist(), stream_gate=gates.tolist(),
        per_stream_force=got["per_stream_force"].tolist(),
        per_stream_force_cpu=cpu["per_stream_force"].tolist(),
        aux_per_stream_force=got_aux["per_stream_force"].tolist(),
        total_force_N=float(got["total_force_N"]), max_depth_mm=float(got["max_depth_mm"]),
        contact_area_mm2=float(got["contact_area_mm2"]),
        map_max=limb.max(axis=(1, 2)).tolist(), canvas_max=float(canvas.max()),
        gaps_vs_cpu={k: float(v.max()) for k, v in gaps.items()}, gate_gap=gate_gap,
        cpu_seconds=cpu_s, launches=launches,
        launches_per_stream_frame={k: v / (2 * STREAMS) for k, v in launches.items()})
    for k, v in gaps.items():
        assert float(v.max()) <= FORCE_RTOL, (k, v)
    assert np.isfinite(limb).all() and float(limb.max()) > 0.01
    hold_limb_to_jax((refs, defs, (pose, accel)), got, got_aux)

    time_limb("limb640", bf, mesh, rs, ds, aux, card)
    return lambda: step(rs, ds), lambda: step_aux(rs, ds, aux)


def stream_inputs():
    """The streams' inputs: the deploy preset, one reference a stream and
    BATCHES batches of deformed frames, each stream's dent depth stepping
    through DENTS_RAD."""
    from vistaf_torch.config import slice_ftp_config
    from vistaf_torch.utils.synthetic import synthetic_pair
    cfg = slice_ftp_config(H, W)
    refs = np.stack([synthetic_pair(H, W, cfg, seed=SEED + s)[0] for s in range(STREAMS)])
    seq = [np.stack([synthetic_pair(H, W, cfg, seed=SEED + s,
                                    dent_depth_rad=DENTS_RAD[(s + t) % len(DENTS_RAD)])[1]
                     for s in range(STREAMS)]) for t in range(BATCHES)]
    return cfg, refs, seq


def limb_inputs():
    """The limb heads' inputs: the deploy preset, the four streams of
    ``run_streams``' first batch, the poses as scripts/bench_streams.py
    draws them, and the accelerations (one stream moving at 30 m/s^2, gate
    0; one at 11 m/s^2, gate 0.5; the rest still)."""
    from vistaf_torch.config import slice_ftp_config
    from vistaf_torch.utils.synthetic import synthetic_pair
    cfg = slice_ftp_config(H, W)
    refs = np.stack([synthetic_pair(H, W, cfg, seed=SEED + s)[0] for s in range(STREAMS)])
    defs = np.stack([synthetic_pair(H, W, cfg, seed=SEED + s, dent_depth_rad=DENTS_RAD[s])[1]
                     for s in range(STREAMS)])
    rng = np.random.default_rng(5)
    pose = np.stack([rng.integers(0, LIMB_CANVAS[0] - H, STREAMS),
                     rng.integers(0, LIMB_CANVAS[1] - W, STREAMS)], axis=1).astype(np.int32)
    accel = np.zeros((STREAMS, 3), np.float32)
    accel[-1], accel[-2] = (30.0, 0.0, 0.0), (0.0, 11.0, 0.0)
    return cfg, refs, defs, (pose, accel)


def time_limb(path, bf, mesh, rs, ds, aux, card, **extra):
    """A ``timing`` line for each head over this rank's streams ``rs``,
    ``ds``: p50 and p90 a step (CUDA events, 2 warm-up, 8 timed), the step
    rate, and the fusion alone (the head over the streams' results computed
    before: everything after the forwards), with the NCCL version."""
    import torch
    from vistaf_torch.parallel import whole_limb_step, whole_limb_step_aux
    step = whole_limb_step(bf, mesh, map_stride=LIMB_STRIDE)
    step_aux = whole_limb_step_aux(bf, mesh, LIMB_CANVAS, map_stride=LIMB_STRIDE)
    replay = _Replay([bf._single(rs[s], ds[s]) for s in range(rs.shape[0])], bf.depth_eps_mm)
    fuse = whole_limb_step(replay, mesh, map_stride=LIMB_STRIDE)
    fuse_aux = whole_limb_step_aux(replay, mesh, LIMB_CANVAS, map_stride=LIMB_STRIDE)
    for name, fn, fusion in ((path, lambda: step(rs, ds), lambda: fuse(rs, ds)),
                             (f"{path}_aux", lambda: step_aux(rs, ds, aux),
                              lambda: fuse_aux(rs, ds, aux))):
        times = []
        for _ in range(2 + 8):
            a, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            e.record()
            torch.cuda.synchronize()
            times.append(a.elapsed_time(e))
        p50 = float(np.percentile(times[2:], 50))
        say("timing", path=name, streams=STREAMS, local_streams=int(rs.shape[0]),
            steps_timed=len(times) - 2, p50_ms_per_step=p50,
            p90_ms_per_step=float(np.percentile(times[2:], 90)), step_hz=1000.0 / p50,
            fusion_ms=cuda_ms(fusion, reps=20, warmup=2),
            nccl=".".join(map(str, torch.cuda.nccl.version())), card=card, **extra)


def probe_host_libraries():
    """Which of the figure writers' and temperature bundles' host libraries
    this machine has (an import probe, not a caught failure)."""
    import importlib.util
    return {m: importlib.util.find_spec(m) is not None for m in ("matplotlib", "joblib", "sklearn")}


@contextlib.contextmanager
def staged(timer, patches):
    """While the block runs, each call of ``owner.attr`` for (owner, attr,
    stage) in ``patches`` is timed under ``timer.stage(stage)``; a call made
    inside another timed call is not timed again."""
    active = []

    def wrap(fn, stage):
        def timed(*a, **k):
            if active:
                return fn(*a, **k)
            active.append(stage)
            try:
                with timer.stage(stage):
                    return fn(*a, **k)
            finally:
                active.pop()
        return timed

    saved = [(owner, attr, vars(owner)[attr]) for owner, attr, _ in patches]
    try:
        for owner, attr, stage in patches:
            setattr(owner, attr, wrap(getattr(owner, attr), stage))
        yield
    finally:
        for owner, attr, raw in saved:
            setattr(owner, attr, raw)


def drive_counted(device, fn, patches):
    """fn() with the launches counted from 0 and the stages timed: (its
    result, its stdout, the launches, {stage: ms}); the wall time that no
    stage took is the writers'."""
    from io import StringIO
    import torch
    from vistaf_torch import kernels
    from vistaf_torch.utils.profiling import StageTimer
    timer = StageTimer(device)
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    with staged(timer, patches), contextlib.redirect_stdout(StringIO()) as text:
        out = fn()
    torch.cuda.synchronize()
    total_ms = (time.perf_counter() - t0) * 1e3
    launches = dict(kernels.LAUNCHES)
    ms = {k: v * 1e3 for k, v in timer.totals.items()}
    ms["writers"] = total_ms - sum(ms.values())
    ms["total"] = total_ms
    return out, text.getvalue(), launches, ms


def file_tree(root) -> set:
    return {os.path.relpath(os.path.join(d, f), root)
            for d, _, files in os.walk(root) for f in files}


def write_frames(root, tag, ref, de):
    """The pair as lossless PNGs under ``root``; returns their paths."""
    import cv2
    paths = []
    for name, frame in (("ref", ref), ("def", de)):
        paths.append(os.path.join(root, f"{tag}_{name}.png"))
        assert cv2.imwrite(paths[-1], frame), paths[-1]
    return paths


def write_temperature_bundles(root, color, wide):
    """The reference layout's COLOR and WIDE joblib bundles (sklearn
    pipelines, as the JAX trainer exports them) of ``color`` and ``wide``."""
    import joblib
    from sklearn.isotonic import IsotonicRegression
    from sklearn.linear_model import HuberRegressor
    from sklearn.pipeline import make_pipeline
    from sklearn.preprocessing import PolynomialFeatures, StandardScaler
    from vistaf_torch.config import TEMP_COLOR_MODEL_GLOB, TEMP_WIDE_MODEL_GLOB

    for m, glob_, name in ((color, TEMP_COLOR_MODEL_GLOB, "color_model_global_huber_deg"),
                           (wide, TEMP_WIDE_MODEL_GLOB, "black_model_global_huber_deg")):
        nf = len(m.feature_names)
        sc = StandardScaler()
        sc.mean_, sc.scale_ = np.asarray(m.scaler_mean, float), np.asarray(m.scaler_scale, float)
        sc.var_, sc.n_features_in_, sc.n_samples_seen_ = sc.scale_ ** 2, nf, 1
        pf = PolynomialFeatures(degree=m.poly_degree, include_bias=True).fit(np.zeros((1, nf)))
        hub = HuberRegressor()
        hub.coef_, hub.intercept_ = np.asarray(m.coef, float), float(m.intercept)
        iso = None
        if m.iso_x is not None:
            iso = IsotonicRegression(out_of_bounds="clip").fit(m.iso_x, m.iso_y)
        path = os.path.join(root, os.path.dirname(glob_), f"{name}{m.poly_degree}.joblib")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        joblib.dump({"model": make_pipeline(sc, pf, hub), "use_features": m.feature_names,
                     "isotonic_calibrator": iso, "name": m.name}, path)


def check_temperature_files(out, t):
    """The mask PNGs and .npy maps under ``out`` against a temperature
    output dict, bit for bit; returns the names that differ."""
    import cv2
    from vistaf_torch.runner.io import crop2d
    bad = []
    for name, key in MASK_KEYS.items():
        got = cv2.imread(os.path.join(out, name), cv2.IMREAD_UNCHANGED)
        if not np.array_equal(got, crop2d(t[key], t["crop_bbox"]).astype(np.uint8) * 255):
            bad.append(name)
    for key in ("temperature_map_final", "temperature_map_fused"):
        if not np.array_equal(np.load(os.path.join(out, f"{key}.npy")), t[key], equal_nan=True):
            bad.append(f"{key}.npy")
    return bad


def run_runner(device, rows, card, force_pipes, sessions, temp_parity):
    """The runner phase at 2160x3840: the ``force`` command whole through
    ``cli.main`` under both presets (``force_pipes``: the constructor-built
    pipelines of the same presets, for the direct call), and ``run_session``
    over ``sessions``' multimodal pipelines (parity sequential, deploy
    ``fused_step``), each with the launch counts set to 0 just before and
    its wall time split by ``StageTimer``; where matplotlib is present also
    ``force --debug``, and with joblib and sklearn the ``temperature``
    command."""
    from vistaf_torch.calib import artifacts
    from vistaf_torch.config import (HEIGHT_TO_FORCE_JSON, PHASE_TO_HEIGHT_JSON, FTPConfig,
                                     SessionConfig)
    from vistaf_torch.pipelines.force import ForcePipeline
    from vistaf_torch.pipelines.multimodal import MultimodalPipeline
    from vistaf_torch.runner import cli, io
    from vistaf_torch.runner.session import run_session
    from vistaf_torch.utils.synthetic import synthetic_deploy_temp_weights, synthetic_pair

    libs = probe_host_libraries()
    say("runner_probe", **libs)
    figures = libs["matplotlib"]

    def drive(fn, patches):
        return drive_counted(device, fn, patches)

    cli_stages = [(ForcePipeline, "from_artifacts", "setup"), (io, "imread_bgr", "decode"),
                  (ForcePipeline, "__call__", "forward")]
    with tempfile.TemporaryDirectory() as root:
        artifacts.save_json(os.path.join(root, PHASE_TO_HEIGHT_JSON),
                            {"best_model": P2H_MODEL, "use_negated_height_for_fit": True})
        artifacts.save_json(os.path.join(root, HEIGHT_TO_FORCE_JSON),
                            {"best_model": FORCE_MODEL})
        ref, de = synthetic_pair(H4K, W4K, FTPConfig(), seed=SEED)
        ref_p, def_p = write_frames(root, "force", ref, de)
        for preset, direct in force_pipes.items():
            out = os.path.join(root, f"force_{preset}")
            argv = ["force", "--ref", ref_p, "--def", def_p, "--out", out, "--data-root", root,
                    "--export-heightmaps", "--preset", preset]
            rc, text, launches, ms = drive(lambda: cli.main(argv), cli_stages)
            want = direct(ref, de)
            with open(os.path.join(out, "result.json")) as f:
                got = json.load(f)
            hm = np.load(os.path.join(out, "ftp_run", "height_map_crop.npy"))
            files = file_tree(out)
            gap = abs(got["force_N"] - want["force_N"]) / abs(want["force_N"])
            say("runner", command="force", preset=preset, force_N=got["force_N"],
                force_N_direct=want["force_N"], force_gap=gap,
                height_map_equal=bool(np.array_equal(hm, want["height_map_mm_crop"],
                                                     equal_nan=True)),
                files=sorted(files), stdout=text.splitlines(), launches=launches)
            say("runner_timing", command="force", preset=preset, ms=ms, card=card)
            record_launches(f"cli_force_{preset}", rows, launches)
            assert rc == 0 and files == set(FORCE_CLI_FILES), (rc, files)
            assert gap <= 1e-6, (got["force_N"], want["force_N"])
            np.testing.assert_array_equal(hm, want["height_map_mm_crop"])

        session_stages = [(io, "imread_bgr", "decode"),
                          (MultimodalPipeline, "ingest", "forward"),
                          (MultimodalPipeline, "__call__", "forward"),
                          (MultimodalPipeline, "step_fused", "forward")]
        for preset, (mm, fused, ref_m, de_m) in sessions.items():
            paths = write_frames(root, f"mm_{preset}", ref_m, de_m)
            cfg = SessionConfig(output_root=os.path.join(root, f"sessions_{preset}"),
                                save_summary_figures=figures, fused_step=fused)
            summary, _, launches, ms = drive(
                lambda: run_session(mm, *paths, root, cfg, timestamp=preset), session_stages)
            direct = mm.step_fused(ref_m, de_m, fetch="maps") if fused else mm(ref_m, de_m)
            f, t = direct["force"], direct["temperature"]
            want = {"force": {"force_N": f["force_N"], "volume_cm3": f["volume_cm3"],
                              "contact_area_mm2": f["contact_area_mm2"],
                              "max_depth_mm": f["max_depth_mm"],
                              "scale_mm_per_px": f["mm_per_px"]},
                    "temperature": direct["temperature_stats"]}
            sdir = os.path.join(cfg.output_root, f"session_{preset}")
            files = file_tree(sdir)
            hm = np.load(os.path.join(sdir, "force_sensing", "ftp_run", "height_map_crop.npy"))
            bad = check_temperature_files(os.path.join(sdir, "temperature_sensing"), t)
            if not np.array_equal(hm, f["height_map_mm_crop"], equal_nan=True):
                bad.append("height_map_crop.npy")
            say("runner", command="session", preset=preset, fused_step=fused,
                figures=figures, sensor_readings=summary["sensor_readings"],
                readings_equal=summary["sensor_readings"] == want, files_differ=bad,
                files=len(files), launches=launches)
            say("runner_timing", command="session", preset=preset, fused_step=fused, ms=ms,
                card=card)
            record_launches(f"session_{preset}", rows, launches)
            assert summary["sensor_readings"] == want, (summary["sensor_readings"], want)
            assert not bad, bad
            assert files == set(SESSION_FILES) if not figures else files > set(SESSION_FILES)

        if figures:
            out = os.path.join(root, "force_debug")
            cli.main(["force", "--ref", ref_p, "--def", def_p, "--out", out, "--data-root",
                      root, "--export-heightmaps", "--debug"])
            files = file_tree(out)
            want = {f"ftp_run/{n}" for n in FTP_DEBUG_FILES} | set(FORCE_CLI_FILES)
            say("runner", command="force --debug", preset="parity", files=len(files),
                missing=sorted(want - files))
            assert want <= files, want - files
        if figures and libs["joblib"] and libs["sklearn"]:
            write_temperature_bundles(root, *synthetic_deploy_temp_weights(SEED))
            out = os.path.join(root, "temperature")
            cli.main(["temperature", "--image", os.path.join(root, "mm_parity_def.png"),
                      "--out", out, "--data-root", root, "--debug"])
            bad = check_temperature_files(out, temp_parity(sessions["parity"][3]))
            say("runner", command="temperature", preset="parity", files=len(file_tree(out)),
                files_differ=bad)
            assert not bad, bad



@contextlib.contextmanager
def figure_recorders(enabled: bool, sink: list):
    """Where matplotlib is missing (``enabled``), the figure writers of
    ``vistaf_torch.trainers.plots`` (``FIGURE_WRITERS``) record the paths
    they would write into ``sink`` instead of drawing, for this block only."""
    from vistaf_torch.trainers import plots
    saved = {name: getattr(plots, name) for name in FIGURE_WRITERS} if enabled else {}

    def recorder(names):
        def record(target, *a, **k):
            sink.extend([os.path.join(target, n) for n in names] if names else [target])
        return record
    try:
        for name, names in FIGURE_WRITERS.items() if enabled else ():
            setattr(plots, name, recorder(names))
        yield
    finally:
        for name, fn in saved.items():
            setattr(plots, name, fn)


def trained_tree(out, recorded):
    """The files a trainer left under ``out`` and the figures it recorded."""
    return file_tree(out) | {os.path.relpath(p, out) for p in recorded
                             if os.path.dirname(os.path.abspath(p)) == os.path.abspath(out)}


def huber_objective(model, X, y, epsilon, alpha):
    """The sklearn Huber objective a trainer's fit minimizes, at the fit's
    (coef, intercept, sigma), on its own scaled polynomial features of
    ``X`` (``calib/huber.py``), in float64 on the CPU."""
    import torch
    from vistaf_torch.calib import huber
    Xs = (torch.as_tensor(np.asarray(X, np.float64)) - torch.as_tensor(model.scaler_mean)) \
        / torch.as_tensor(model.scaler_scale)
    P = huber.poly_features(Xs, model.powers)
    f = model.fit_
    return huber._objective(P, torch.as_tensor(np.asarray(y, np.float64)),
                            torch.as_tensor(f.coef), f.intercept, f.sigma, epsilon, alpha)


def weight_gaps(a, b):
    """(the determined coefficients' largest gap relative to the largest
    coefficient, the gap of coef[0] + intercept relative to it, the gap of
    the split between them): the polynomial's bias column duplicates the
    intercept, so only their sum is determined (``calib/huber.py``)."""
    ca, cb = np.asarray(a.coef, float), np.asarray(b.coef, float)
    scale = float(np.abs(cb).max())
    s_a, s_b = ca[0] + a.intercept, cb[0] + b.intercept
    return (float(np.abs(ca[1:] - cb[1:]).max(initial=0.0)) / scale,
            abs(s_a - s_b) / abs(s_b), abs(a.intercept - b.intercept))


def temperature_series(root, stem, temps, frames, seed, t_span=None, jitter=1.0):
    """``synthetic_tlc_series`` at 2160x3840 as JPEGs ``{stem}-{i}.jpg``."""
    import cv2
    from vistaf_torch.utils.synthetic import synthetic_tlc_series
    os.makedirs(root, exist_ok=True)
    per = [t for t in temps for _ in range(frames)]
    for i, img in enumerate(synthetic_tlc_series(H4K, W4K, per, t_span=t_span, jitter=jitter,
                                                 seed=seed), 1):
        assert cv2.imwrite(os.path.join(root, f"{stem}-{i}.jpg"), img)
    return os.path.join(root, f"{stem}-*.jpg")


def run_force_trainers(device, rows, card, root, route, figures):
    """``train-p2h`` and ``train-h2f`` (twice: the second resumes) through
    ``cli.main`` on a 2160x3840 indentation series written as JPEGs."""
    import csv
    import cv2
    import torch
    from vistaf_torch.calib import artifacts, fitting
    from vistaf_torch.config import ForceConfig, FTPConfig
    from vistaf_torch.ftp.pipeline import FTPPipeline
    from vistaf_torch.pipelines.force import ForcePipeline
    from vistaf_torch.runner import cli, io
    from vistaf_torch.trainers import phase_to_height
    from vistaf_torch.utils.synthetic import synthetic_indentation_series

    data = os.path.join(root, "force")
    os.makedirs(data)
    ref, defs = synthetic_indentation_series(H4K, W4K, FTPConfig(),
                                             P2H_DENTS_RAD + H2F_DENTS_RAD, seed=SEED)
    ref_p = os.path.join(data, "reference.jpg")
    assert cv2.imwrite(ref_p, ref)
    p2h_names = [n for n, _ in phase_to_height.DEFAULT_CALIBRATION_SAMPLES]
    h2f_names = [f"sphere-{1 + 5 * k}.jpg" for k in range(len(H2F_DENTS_RAD))]
    for name, im in zip(p2h_names + h2f_names, defs):
        assert cv2.imwrite(os.path.join(data, name), im)
    del defs
    stages = [(FTPPipeline, "__init__", "setup"), (io, "imread_bgr", "decode"),
              (FTPPipeline, "forward", "forward_fit"), (fitting, "fit_best_model", "forward_fit")]

    # --- train-p2h
    out_p2h, recorded = os.path.join(root, "p2h"), []
    with figure_recorders(not figures, recorded):
        rc, text, launches, ms = drive_counted(device, lambda: cli.main(
            ["train-p2h", "--ref", ref_p, "--deformed-dir", data, "--out", out_p2h]), stages)
    record_launches("train_p2h", rows, launches, frames=len(p2h_names))
    with open(os.path.join(out_p2h, "calibration_results.csv"), newline="") as f:
        p2h_rows = list(csv.DictReader(f))
    # the first frame against the port's CPU run given the card's alignment
    ref_u8, de_u8 = io.imread_bgr(ref_p), io.imread_bgr(os.path.join(data, p2h_names[0]))
    args = (phase_to_height.trainer_ftp_config(), ForceConfig(),
            {"type": "linear0", "params": {"a": 1.0}}, FORCE_MODEL)
    dbg = ForcePipeline(*args, debug_outputs=True, device=device)(ref_u8, de_u8)
    same, _, same_s = same_alignment(args, ref_u8, de_u8, dbg)
    mins = [phase_to_height.compute_min_height(torch.as_tensor(r["height_map_unitless_crop"]),
                                               torch.as_tensor(r["roi_eroded_crop"]))
            for r in (dbg, same)]
    got = float(p2h_rows[0]["min_height_unitless"])
    gap = abs(got - mins[1][0]) / abs(mins[1][0])
    files = trained_tree(out_p2h, recorded)
    model = artifacts.load_json(os.path.join(out_p2h, "calibration_model.json"))
    say("trainers", trainer="train-p2h", frames=len(p2h_names), decode_route=route,
        launches=launches, rows=p2h_rows, best_model=model["best_model"]["type"],
        min_height_first=got, min_height_first_card_debug=mins[0][0],
        min_height_first_cpu_same_alignment=mins[1][0], min_xy_cpu=mins[1][1],
        min_height_gap=gap, cpu_seconds=same_s, files=sorted(files),
        figures_recorded=not figures, stdout_lines=len(text.splitlines()))
    say("trainers_timing", trainer="train-p2h", frames=len(p2h_names), ms=ms, card=card)
    assert rc == 0 and files == set(P2H_FILES), (rc, files)
    assert len(p2h_rows) == len(p2h_names) and all(
        float(r["min_height_unitless"]) < 0 for r in p2h_rows), p2h_rows
    assert gap <= TRAINER_MIN_RTOL, (got, mins)

    # --- train-h2f on the p2h model just written, then resumed
    p2h_json = os.path.join(out_p2h, "calibration_model.json")
    out_h2f = os.path.join(root, "h2f")
    argv = ["train-h2f", "--ref", ref_p, "--deformed-dir", data, "--p2h-json", p2h_json,
            "--out", out_h2f]
    recorded = []
    with figure_recorders(not figures, recorded):
        rc, _, launches, ms = drive_counted(device, lambda: cli.main(argv), stages)
    record_launches("train_h2f", rows, launches, frames=len(h2f_names))
    files = trained_tree(out_h2f, recorded)
    with open(os.path.join(out_h2f, "per_image_results.csv"), newline="") as f:
        h2f_rows = list(csv.DictReader(f))
    with open(os.path.join(out_h2f, "calibration_model.json"), "rb") as f:
        first_json = f.read()
    p2h, use_neg = artifacts.load_phase_to_height(p2h_json)
    direct = ForcePipeline(FTPConfig(), ForceConfig(), p2h, FORCE_MODEL, use_neg, device=device)
    volumes = [direct(ref_u8, io.imread_bgr(os.path.join(data, r["file"])))["volume_cm3"]
               for r in h2f_rows]
    equal = [float(r["volume_cm3"]) == v for r, v in zip(h2f_rows, volumes)]
    with figure_recorders(not figures, []):
        rc2, _, launches2, ms2 = drive_counted(device, lambda: cli.main(argv), stages)
    record_launches("train_h2f_resume", rows, launches2)
    with open(os.path.join(out_h2f, "calibration_model.json"), "rb") as f:
        same_json = f.read() == first_json
    model = json.loads(first_json)
    say("trainers", trainer="train-h2f", frames=len(h2f_names), decode_route=route,
        launches=launches, volumes_cm3=[float(r["volume_cm3"]) for r in h2f_rows],
        volumes_equal_force_pipeline=equal, best_model=model["best_model"]["type"],
        rmse=model["best_model"]["rmse"], files=sorted(files), figures_recorded=not figures,
        resume_launches=launches2, resume_same_model_json=same_json)
    say("trainers_timing", trainer="train-h2f", frames=len(h2f_names), ms=ms, card=card)
    say("trainers_timing", trainer="train-h2f (resume)", frames=0, ms=ms2, card=card)
    assert rc == rc2 == 0 and files == set(H2F_FILES), (rc, rc2, files)
    assert [r["file"] for r in h2f_rows] == h2f_names, h2f_rows
    assert all(equal), (h2f_rows, volumes)
    assert same_json


def temperature_trainer_files(kind, summary, joblib_too):
    names = set(COLOR_TRAINER_FILES if kind == "color" else BLACK_TRAINER_FILES)
    for variant, v in summary["models_final"].items():
        stem = f"{kind}_model_{variant}_huber_deg{v['degree']}"
        names |= {stem + ".npz"} | ({stem + ".joblib"} if joblib_too else set())
    return names


def run_temperature_trainers(device, rows, card, root, route, figures, joblib_too):
    """``temperature_color.train`` and ``temperature_black.train`` at
    2160x3840 with the real annulus, degrees, CV splits, Huber constants and
    4000 px an image, on 7 temperatures x 2 frames a run, on the card and on
    the port's CPU; returns the card's output directories."""
    from vistaf_torch.calib import huber
    from vistaf_torch.runner import io, native
    from vistaf_torch.trainers import temperature_black, temperature_color
    from vistaf_torch.trainers import temperature_common as tc

    heat = temperature_series(os.path.join(root, "heat"), "heating", TRAIN_TEMPS,
                              TRAIN_FRAMES, SEED + 1)
    cool = temperature_series(os.path.join(root, "cool"), "cooling", TRAIN_TEMPS[::-1],
                              TRAIN_FRAMES, SEED + 2, t_span=(TRAIN_TEMPS[0], TRAIN_TEMPS[-1]))
    frames = 2 * len(TRAIN_TEMPS) * TRAIN_FRAMES
    outs = {}
    for kind, mod in (("color", temperature_color), ("black", temperature_black)):
        stages = [(tc, "annulus_roi", "setup"), (io, "imread_bgr", "decode"),
                  (native, "decode_jpeg_batch", "decode"),
                  (tc, "feature_planes_u8", "forward_fit"),
                  (tc, "masked_means_f32", "forward_fit"),
                  (tc, "fit_huber_poly", "forward_fit"), (mod, "fit_huber_poly", "forward_fit")]

        def train(dev, out):
            return mod.train(heat, cool, out, temps_heating=TRAIN_TEMPS,
                             frames_per_temp=TRAIN_FRAMES, inner_circle=mod.INNER_CIRCLE,
                             outer_circle=mod.OUTER_CIRCLE, device=dev)
        outs[kind] = out = os.path.join(root, f"temp_{kind}")
        recorded, fits = [], {device.type: [], "cpu_run": []}
        final_fit = mod.fit_huber_poly

        def keep(sink):
            def fit(X, y, *a, **k):
                sink.append((X, y, final_fit(X, y, *a, **k)))
                return sink[-1][2]
            return fit
        mod.fit_huber_poly = keep(fits[device.type])
        try:
            with figure_recorders(not figures, recorded):
                summary, _, launches, ms = drive_counted(device, lambda: train(device, out),
                                                         stages)
            record_launches(f"train_temp_{kind}", rows, launches)
            mod.fit_huber_poly = keep(fits["cpu_run"])
            t0 = time.perf_counter()
            with figure_recorders(not figures, []):
                summary_cpu = train("cpu", out + "_cpu")
            cpu_s = time.perf_counter() - t0
        finally:
            mod.fit_huber_poly = final_fit
        degrees = {k: v["degree"] for k, v in summary["models_final"].items()}
        degrees_cpu = {k: v["degree"] for k, v in summary_cpu["models_final"].items()}
        metric_gap = max(abs(float(m[k]) - float(mc[k]))
                         for v, vc in zip(summary["models_final"].values(),
                                          summary_cpu["models_final"].values())
                         for part in ("metrics_frames", "metrics_means")
                         for m, mc in ((v[part], vc[part]),) for k in m)
        # the final fits (heating, cooling, global), card against CPU: the
        # objective each minimizes, its predictions on its samples, rounds
        fit_report = {}
        for variant, (X, y, fc), (_, _, fp) in zip(("heating", "cooling", "global"),
                                                   fits[device.type], fits["cpu_run"]):
            oc, op = (huber_objective(f, X, y, mod.HUBER_EPSILON, mod.HUBER_ALPHA)
                      for f in (fc, fp))
            fit_report[variant] = {
                "rounds": [fc.fit_.n_iter, fp.fit_.n_iter], "sigma": [fc.fit_.sigma, fp.fit_.sigma],
                "objective": [oc, op], "objective_gap": abs(oc - op) / abs(op),
                "predict_gap_C": float(np.abs(fc.predict(X) - fp.predict(X)).max()),
                "weight_gaps": weight_gaps(fc.fit_, fp.fit_),
                "samples": int(len(y))}
        files = trained_tree(out, recorded)
        want = temperature_trainer_files(kind, summary, joblib_too)
        say("trainers", trainer=f"train-temp-{kind}", frames=frames, decode_route=route,
            launches=launches, degrees=degrees, degrees_cpu=degrees_cpu,
            metrics_global_frames=summary["models_final"]["global"]["metrics_frames"],
            metric_gap_cpu=metric_gap, final_fits_vs_cpu=fit_report, cpu_seconds=cpu_s,
            files=sorted(files), missing=sorted(want - files), figures_recorded=not figures)
        say("trainers_timing", trainer=f"train-temp-{kind}", frames=frames, ms=ms, card=card)
        assert degrees == degrees_cpu, (degrees, degrees_cpu)
        assert metric_gap <= TRAINER_METRIC_ATOL, metric_gap
        assert len(fit_report) == 3, fit_report
        for variant, r in fit_report.items():
            if max(r["rounds"]) >= HUBER_MAX_ROUNDS or min(r["sigma"]) <= HUBER_SIGMA_FLOOR:
                continue        # no minimizer reached: reported, not held
            g = r["weight_gaps"]
            assert r["rounds"][0] == r["rounds"][1], (variant, r)
            assert g[0] <= TRAINER_COEF_RTOL and g[1] <= TRAINER_COEF_RTOL \
                and g[2] <= SPLIT_ATOL and r["objective_gap"] <= TRAINER_OBJECTIVE_RTOL, \
                (variant, r)
        assert files == want, (sorted(files), sorted(want))

    # --- the black trainer's global fit at its real sample count
    rng = np.random.default_rng(SEED)
    T = np.repeat(np.asarray(HUBER_TEMPS, float), HUBER_FRAMES * HUBER_PX)
    T = np.concatenate([T, T])                  # heating and cooling runs
    d = T - 45.0
    X = np.stack([120.0 + 1.5 * d + 0.01 * d * d, 128.0 + 0.2 * d, 125.0 - 0.15 * d,
                  110.0 + 1.4 * d], axis=1) + rng.normal(scale=[3.0, 2.0, 2.0, 3.0],
                                                         size=(T.size, 4))
    X = np.round(np.clip(X, 0, 255)).astype(np.float32)   # 8-bit features, as cv2's
    X[::97] = rng.integers(0, 256, size=X[::97].shape)    # outlier pixels
    eps, alpha = temperature_black.HUBER_EPSILON, temperature_black.HUBER_ALPHA
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fit = huber.fit_huber_poly(X, T, HUBER_DEGREE, eps, alpha, device=device)
    torch.cuda.synchronize()
    fit_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    fit_cpu = huber.fit_huber_poly(X, T, HUBER_DEGREE, eps, alpha, device="cpu")
    cpu_ms = (time.perf_counter() - t0) * 1e3
    gaps = weight_gaps(fit.fit_, fit_cpu.fit_)
    say("trainers", trainer="huber_fit", samples=int(T.size), terms=int(fit.powers.shape[0]),
        degree=HUBER_DEGREE, iterations=fit.fit_.n_iter, iterations_cpu=fit_cpu.fit_.n_iter,
        sigma=fit.fit_.sigma, sigma_cpu=fit_cpu.fit_.sigma, weight_gaps_cpu=gaps)
    say("trainers_timing", trainer="huber_fit", samples=int(T.size),
        iterations=fit.fit_.n_iter, ms=fit_ms, ms_per_iteration=fit_ms / fit.fit_.n_iter,
        cpu_ms=cpu_ms, card=card)
    assert fit.fit_.n_iter == fit_cpu.fit_.n_iter, (fit.fit_.n_iter, fit_cpu.fit_.n_iter)
    assert gaps[0] <= HUBER_COEF_RTOL and gaps[1] <= HUBER_COEF_RTOL \
        and gaps[2] <= SPLIT_ATOL, gaps
    return outs


def run_roundtrip(device, rows, outs):
    """The trained global models (``color_model_global_huber_deg*.npz``,
    ``black_model_global_huber_deg*.npz``) loaded with
    ``TempModelWeights.load_npz`` and served by ``TemperaturePipeline`` on
    the card under ``TempConfig().deploy()`` (K1, K3, K8) and
    ``TempConfig()`` (K3), each held to the port's CPU run under the
    deploy contract."""
    import glob
    import torch
    from vistaf_torch import kernels
    from vistaf_torch.calib.temp_weights import TempModelWeights
    from vistaf_torch.config import TempConfig
    from vistaf_torch.temperature.inference import TemperaturePipeline
    from vistaf_torch.utils.synthetic import synthetic_tlc_frame

    (cp,) = glob.glob(os.path.join(outs["color"], "color_model_global_huber_deg*.npz"))
    (wp,) = glob.glob(os.path.join(outs["black"], "black_model_global_huber_deg*.npz"))
    color, wide = TempModelWeights.load_npz(cp), TempModelWeights.load_npz(wp)
    frame = synthetic_tlc_frame(H4K, W4K, TempConfig(), SEED)
    for path, cfg in (("roundtrip_deploy", TempConfig().deploy()),
                      ("roundtrip_parity", TempConfig())):
        gpu = TemperaturePipeline(cfg, color, wide, device=device)
        torch.cuda.synchronize()
        kernels.reset_launches()
        res = gpu(frame)
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        record_launches(path, rows, launches)
        st = gpu.stats(frame)
        t0 = time.perf_counter()
        st_cpu = TemperaturePipeline(cfg, color, wide, device="cpu").stats(frame)
        cpu_s = time.perf_counter() - t0
        gaps = {k: abs(float(st[k]) - float(st_cpu[k])) for k in ("t_mean", "t_min", "t_max")}
        valid, valid_cpu = int(st["valid_pixels"]), int(st_cpu["valid_pixels"])
        valid_gap = abs(valid - valid_cpu) / max(valid_cpu, 1)
        say("trainers", trainer="roundtrip", path=path, color_model=os.path.basename(cp),
            wide_model=os.path.basename(wp), launches=launches,
            **{k: float(st[k]) for k in ("t_mean", "t_min", "t_max")},
            **{f"{k}_cpu": float(st_cpu[k]) for k in ("t_mean", "t_min", "t_max")},
            **{f"{k}_gap": v for k, v in gaps.items()}, valid_pixels=valid,
            valid_pixels_cpu=valid_cpu, valid_pixels_gap=valid_gap,
            iso_knots=0 if color.iso_x is None else len(color.iso_x), cpu_seconds=cpu_s)
        assert res["temperature_map_final"].shape == (H4K, W4K)
        assert valid_cpu > 0 and np.isfinite([float(st[k]) for k in gaps]).all(), st
        assert gaps["t_mean"] <= T_MEAN_ATOL, gaps
        assert gaps["t_min"] <= T_EXTREME_ATOL and gaps["t_max"] <= T_EXTREME_ATOL, gaps
        assert valid_gap <= VALID_RTOL, (valid, valid_cpu)


def run_pretest(device, rows, card, root, route, figures):
    """``pretest`` through ``cli.main`` on a settling 2160x3840 series, the
    outer-circle ROI, against the port's CPU run of the same analysis."""
    import cv2
    from vistaf_torch.config import TempConfig
    from vistaf_torch.ops import color as color_ops
    from vistaf_torch.ops import geometry
    from vistaf_torch.runner import cli
    from vistaf_torch.trainers import pretest
    from vistaf_torch.trainers import temperature_common as tc

    pattern = temperature_series(os.path.join(root, "pretest"), "frame", PRETEST_LEVELS, 1,
                                 SEED + 3, jitter=0.0)
    out, recorded, got = os.path.join(root, "pretest_out"), [], []
    analyze = pretest.analyze

    def keep(*a, **k):
        got.append(analyze(*a, **k))
        return got[-1]
    stages = [(cv2, "imread", "decode"), (color_ops, "bgr_to_lab_u8", "forward_fit"),
              (tc, "masked_means_f32", "forward_fit")]
    pretest.analyze = keep
    try:
        with figure_recorders(not figures, recorded):
            rc, _, launches, ms = drive_counted(device, lambda: cli.main(
                ["pretest", "--pattern", pattern, "--out", out, "--label", "settle"]), stages)
    finally:
        pretest.analyze = analyze
    record_launches("pretest", rows, launches)
    cfg = TempConfig()
    c = geometry.circle_from_3_points_exact(cfg.outer_circle_p1, cfg.outer_circle_p2,
                                            cfg.outer_circle_p3)
    t0 = time.perf_counter()
    cpu = pretest.analyze(pattern, geometry.circular_mask(H4K, W4K, *c), device="cpu")
    cpu_s = time.perf_counter() - t0
    (res,) = got
    gap = float(np.abs(np.subtract(res["mean_L"], cpu["mean_L"])).max())
    files = trained_tree(out, recorded)
    say("trainers", trainer="pretest", frames=res["n_frames"], decode_route="cv2",
        launches=launches, stabilization=res["stabilization"],
        stabilization_cpu=cpu["stabilization"], mean_L_first_last=[res["mean_L"][0],
                                                                   res["mean_L"][-1]],
        mean_L_gap_cpu=gap, cpu_seconds=cpu_s, files=sorted(files),
        figures_recorded=not figures)
    say("trainers_timing", trainer="pretest", frames=res["n_frames"], ms=ms, card=card)
    assert rc == 0 and res["n_frames"] == len(PRETEST_LEVELS)
    assert res["stabilization"] is not None and cpu["stabilization"] is not None
    assert res["stabilization"]["index"] == cpu["stabilization"]["index"], \
        (res["stabilization"], cpu["stabilization"])
    assert gap <= MEAN_L_ATOL, gap
    assert files == {"Figure_1_pretest_settle.png"}, files


def run_trainers(device, rows, card):
    """The trainers phase at 2160x3840 (``vistaf_torch/trainers``): the
    force trainers through ``cli.main``, the temperature trainers and the
    real-size Huber fit against the port's CPU, the trained models served
    through ``TemperaturePipeline``, and ``pretest`` through ``cli.main``;
    each with the launch counts set to 0 just before it."""
    from vistaf_torch.runner import native
    libs = probe_host_libraries()
    route = "native" if native.native_available() else "cv2"
    say("trainers_probe", decode_route=route, **libs)
    figures = libs["matplotlib"]
    with tempfile.TemporaryDirectory() as root:
        run_force_trainers(device, rows, card, root, route, figures)
        outs = run_temperature_trainers(device, rows, card, root, route, figures,
                                        libs["joblib"] and libs["sklearn"])
        run_roundtrip(device, rows, outs)
        run_pretest(device, rows, card, root, route, figures)


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

    from vistaf_torch.config import FTPConfig, TempConfig
    device = torch.device("cuda", 0)
    cfgs = force_path_configs()
    clock = {"build": time.perf_counter() - t0}

    def lap(name):
        clock[name] = time.perf_counter() - t0 - sum(clock.values())

    rows = phase_kernels(device)
    lap("kernels")
    runs = {"640": run_path("640", device, rows, *cfgs["640"])[1]}
    force4k, runs["4k"] = run_path("4k", device, rows, *cfgs["4k"])
    temp, frame = run_temperature(device, rows, TempConfig().deploy(), "temp4k")
    runs["temp4k"] = lambda: temp(frame)
    runs["temp4k_stats"] = lambda: temp.stats(frame)
    lap("end_to_end")
    from vistaf_torch.config import ForceConfig
    from vistaf_torch.pipelines.force import ForcePipeline
    debug_4k = ForcePipeline(cfgs["4k"][0], ForceConfig(), P2H_MODEL, FORCE_MODEL,
                             debug_outputs=True, device=device)
    mm, mm_ref, mm_def = run_multimodal(device, rows, debug_4k, temp, "mm4k",
                                        timed_force=force4k)
    runs["mm4k"] = lambda: mm(mm_ref, mm_def)
    runs["mm4k_scalars"] = lambda: mm.step_fused(mm_ref, mm_def, fetch="scalars")
    lap("mm4k")
    runs["streams640"] = run_streams(device, rows, card)
    lap("streams640")
    runs["limb640"], runs["limb640_aux"] = run_limb(device, rows, card)
    lap("limb640")
    runs["hist640"] = run_path("hist640", device, rows, *cfgs["hist640"])[1]
    lap("hist640")
    runs["parity640"] = run_path("parity640", device, rows, *cfgs["parity640"])[1]
    check_from_artifacts(device, *cfgs["parity640"])
    force_p4k, runs["parity4k"] = run_path("parity4k", device, rows, *cfgs["parity4k"])
    lap("parity")
    temp_p, frame_p = run_temperature(device, rows, TempConfig(), "temp4k_parity")
    dep, par = temp.stats(frame_p), temp_p.stats(frame_p)
    say("parity_vs_deploy", path="temp4k_parity", gated=False,
        **{f"{k}_gap": float(par[k]) - float(dep[k]) for k in ("t_mean", "t_min", "t_max")},
        valid_pixels=int(par["valid_pixels"]), valid_pixels_deploy=int(dep["valid_pixels"]))
    runs["temp4k_parity"] = lambda: temp_p(frame_p)
    runs["temp4k_parity_stats"] = lambda: temp_p.stats(frame_p)
    lap("temp4k_parity")
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
    phase_timing("hist640", runs["hist640"], card, frames=10, warmup=2)
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
    phase_profile("limb640", runs["limb640"], frames=2)
    phase_profile("limb640_aux", runs["limb640_aux"], frames=2)
    phase_profile("parity640", runs["parity640"], frames=2)
    phase_profile("hist640", runs["hist640"], frames=2)
    phase_profile("parity4k", runs["parity4k"], frames=1)
    phase_profile("temp4k_parity_stats", runs["temp4k_parity_stats"], frames=1)
    phase_profile("mm4k_parity_scalars", runs["mm4k_parity_scalars"], frames=1)
    lap("profile")
    run_runner(device, rows, card, {"parity": force_p4k, "deploy": force4k},
               {"parity": (mmp, False, mmp_ref, mmp_def), "deploy": (mm, True, mm_ref, mm_def)},
               temp_p)
    lap("runner")
    run_trainers(device, rows, card)
    lap("trainers")
    run_knobs(device, rows, card)
    lap("knobs")
    import torch.distributed as dist
    dist.destroy_process_group()
    say("clock", seconds=clock, total=time.perf_counter() - t0,
        jax=dict(JAX_SECONDS, total=sum(JAX_SECONDS.values())))

    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
