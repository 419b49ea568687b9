"""Chip smoke test of the PyTorch + CUDA port (vistaf_torch) on one GPU.

    python3 chip_smoke.py

Phases, one line each, any failure raises and exits non-zero:
  1. device: requires CUDA, prints the card's name and power limit;
  2. build: compiles the Hopper kernels from vistaf_torch/csrc;
  3. kernels: each of the seven kernels against its plain PyTorch version on
     the card at the shapes its paths give it (236x236 planes for K1, K3,
     K5, K6, K7; the 295x295 coarse ECC grid for K4; the 1182x1182 crop of
     the native-4K path for K1, K2 and K3), with CUDA-event median times of
     both;
  4. end to end at 640x480: ForcePipeline under the deploy preset as
     shipped, K1, K3, K5, K6 and K7 must launch, force within 1% of the
     same port run on the CPU;
  5. end to end at 2160x3840: ForcePipeline under FTPConfig().deploy(), K1,
     K2, K3 and K4 must launch, force within 1% and the ECC warp within
     0.05 px of the port's CPU run;
  6. timing: steady-state frame->force p50/p90, fps and the host syncs one
     frame makes, for both paths (fewer frames at 4K);
  7. profile: device busy share and the heaviest kernels of a few frames of
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
# kernels each path must launch (the JAX package's Pallas routes at that size)
PATH_KERNELS = {
    "640": ("masked_quantiles", "inpaint_diffusion", "ecc_loop_euclidean", "unwrap_wls",
            "robust_polyfit2d"),
    "4k": ("masked_quantiles", "masked_median_mad", "inpaint_diffusion",
           "gn_moments_euclidean"),
}


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


def kernel_cases(device):
    """Inputs at the slice's shapes, made with numpy from SEED, and the
    check each kernel's output must pass against its plain version."""
    import torch
    from vistaf_torch.config import FTPConfig, slice_ftp_config
    from vistaf_torch.ftp.pipeline import FTPGeometry
    from vistaf_torch.kernels import (ecc_kernel, ecc_loop_kernel, inpaint_kernel,
                                      polyfit_kernel, quantile_kernel, unwrap_kernel)
    from vistaf_torch.ops import geometry
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

    # K4: one GN iteration on the 295x295 coarse grid of the 4K preset, K = 4
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

    k1 = ("masked_quantiles", "vistaf_torch/csrc/quantile.cu",
          "vistaf_tpu/pallas/quantile_kernel.py:91",
          quantile_kernel.masked_quantiles, quantile_kernel.masked_quantiles_plain)
    k3 = ("inpaint_diffusion", "vistaf_torch/csrc/inpaint.cu",
          "vistaf_tpu/pallas/inpaint_kernel.py:94",
          inpaint_kernel.inpaint_diffusion, inpaint_kernel.inpaint_diffusion_plain)
    return [
        (*k1, k1_args, k1_check),
        (*k1, k1_4k_args, k1_check),
        (*k3, k3_args, k3_check),
        (*k3, k3_4k_args, k3_check),
        ("ecc_loop_euclidean", "vistaf_torch/csrc/ecc_loop.cu",
         "vistaf_tpu/pallas/ecc_loop_kernel.py:161",
         ecc_loop_kernel.ecc_loop_euclidean, ecc_loop_kernel.ecc_loop_euclidean_plain,
         k5_args, k5_check),
        ("robust_polyfit2d", "vistaf_torch/csrc/polyfit.cu",
         "vistaf_tpu/pallas/polyfit_kernel.py:144",
         polyfit_kernel.robust_polyfit2d_coef,
         polyfit_kernel.robust_polyfit2d_coef_plain, k7_args, k7_check),
        ("masked_median_mad", "vistaf_torch/csrc/quantile.cu",
         "vistaf_tpu/pallas/quantile_kernel.py:133",
         quantile_kernel.masked_median_mad, quantile_kernel.masked_median_mad_plain,
         k2_args, k2_check),
        ("gn_moments_euclidean", "vistaf_torch/csrc/ecc_moments.cu",
         "vistaf_tpu/pallas/ecc_kernel.py:118",
         ecc_kernel.gn_moments_euclidean, ecc_kernel.gn_moments_euclidean_plain,
         k4_args, k4_check),
        ("unwrap_wls", "vistaf_torch/csrc/unwrap.cu",
         "vistaf_tpu/pallas/unwrap_kernel.py:148",
         unwrap_kernel.unwrap_wls, unwrap_kernel.unwrap_wls_plain, k6_args, k6_check),
    ]


def phase_kernels(device):
    """One row per kernel: ``max_abs_err`` over every shape it was checked
    at, ``ms`` and ``plain_ms`` at the first, each shape under ``shapes``."""
    import torch
    rows = {}
    for name, source, replaces, kern, plain, args, check in kernel_cases(device):
        got = kern(*args)
        ref = plain(*args)
        torch.cuda.synchronize()
        err = check(got, ref)
        ms = cuda_ms(lambda: kern(*args))
        plain_ms = cuda_ms(lambda: plain(*args), reps=5, warmup=1)
        shape = list(args[0].shape)
        say("kernel", name=name, shape=shape, max_abs_err=err, ms=ms, plain_ms=plain_ms)
        row = rows.setdefault(name, {"name": name, "route": "cuda", "source": source,
                                     "replaces": replaces, "max_abs_err": err, "ms": ms,
                                     "plain_ms": plain_ms, "shapes": []})
        row["max_abs_err"] = max(row["max_abs_err"], err)
        row["shapes"].append({"shape": shape, "max_abs_err": err, "ms": ms,
                              "plain_ms": plain_ms})
    return list(rows.values())


def run_path(path: str, device, rows, cfg, h: int, w: int):
    """Drive ForcePipeline once on the card with the launch counts set to 0
    just before, check the path's kernels launched and the result against
    the port's CPU run; returns the pipeline and the frames for timing."""
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
    for row in rows:
        row[f"launches_{path}"] = launches[row["name"]]
        row["launches"] = row.get("launches", 0) + launches[row["name"]]
    for name in PATH_KERNELS[path]:
        assert launches[name] > 0, f"{name} was not launched on the {path} path"
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
    say("end_to_end", path=path, force_N=force, force_N_cpu=res_cpu["force_N"],
        force_gap=gap, reliable_agreement=agree, ecc_warp_gap_px=warp_gap,
        ecc_warp=res["dbg_ecc_warp"].tolist(), ecc_warp_cpu=res_cpu["dbg_ecc_warp"].tolist(),
        ecc_iters=int(res["dbg_ecc_iters"]), ecc_iters_cpu=int(res_cpu["dbg_ecc_iters"]),
        cpu_seconds=cpu_s, launches=launches)
    assert gap <= FORCE_RTOL, (force, res_cpu["force_N"])
    assert warp_gap < ECC_ATOL_PX, warp_gap
    return ForcePipeline(*args, device=device), ref, de


def phase_timing(path, gpu, ref, de, card, frames: int, warmup: int):
    import torch
    for _ in range(warmup):
        gpu(ref, de)
    torch.cuda.synchronize()
    times = []
    for _ in range(frames):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        gpu(ref, de)
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    # every host sync of one frame, as PyTorch's sync debug mode reports them
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            gpu(ref, de)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    syncs = sum("synchroniz" in str(w.message) for w in caught)
    p50 = float(np.percentile(times, 50))
    p90 = float(np.percentile(times, 90))
    say("timing", path=path, frames=frames, p50_ms=p50, p90_ms=p90, fps=1000.0 / p50,
        host_syncs_per_frame=syncs, card=card)


def phase_profile(path, gpu, ref, de, frames: int):
    """Device busy share of a steady window: the kernels' self device time
    (``torch.profiler``) over the window's wall time, profiler on, and the
    kernels that take the most of it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    gpu(ref, de)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(frames):
            gpu(ref, de)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / frames
    averages = prof.key_averages()
    # device-side events only (kernels, copies): host ops report their
    # kernels' time too and would count it twice
    events = [e for e in averages
              if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3 / frames
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:8]
    launches = sum(e.count for e in averages if e.key == "cudaLaunchKernel")
    say("profile", path=path, frames=frames, wall_ms_per_frame=wall_ms,
        device_busy_ms_per_frame=busy_ms, device_busy_share=busy_ms / wall_ms,
        cuda_launches_per_frame=launches / frames,
        top=[[e.key[:60], e.self_device_time_total / 1e3 / frames, e.count / frames]
             for e in top])


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

    from vistaf_torch.config import FTPConfig, slice_ftp_config
    device = torch.device("cuda", 0)
    rows = phase_kernels(device)
    runs = {"640": run_path("640", device, rows, slice_ftp_config(H, W), H, W),
            "4k": run_path("4k", device, rows, FTPConfig().deploy(), H4K, W4K)}
    phase_timing("640", *runs["640"], card, frames=40, warmup=5)
    phase_timing("4k", *runs["4k"], card, frames=5, warmup=2)
    phase_profile("640", *runs["640"], frames=5)
    phase_profile("4k", *runs["4k"], frames=2)

    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
