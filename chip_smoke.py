"""Chip smoke test of the PyTorch + CUDA port (vistaf_torch) on one GPU.

    python3 chip_smoke.py

Phases, one line each, any failure raises and exits non-zero:
  1. device: requires CUDA, prints the card's name and power limit;
  2. build: compiles the Hopper kernels from vistaf_torch/csrc;
  3. kernels: each kernel against its plain PyTorch version on the card at
     the 640x480 slice's shapes (236x236 planes, pairs for K1 and K3), with
     CUDA-event median times of both;
  4. end to end: ForcePipeline on the synthetic 640x480 pair with
     device="cuda", every kernel's launch counter must rise, force within
     1% of the same port run on the CPU;
  5. timing: steady-state frame->force p50/p90 over 30+ frames, fps, and the
     host syncs one frame makes.
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
SEED = 0
# calibration models of the 640x480 benchmark (bench.py)
P2H_MODEL = {"type": "hinge_saturating",
             "params": {"a": 2.0826494996246554, "b": 4.20441143052732,
                        "c": -1.767844217125454e-09}}
FORCE_MODEL = {"type": "growth",
               "params": {"a": 1.6197727931063521, "b": 9.756634595755994}}
FORCE_RTOL = 0.01          # the deploy preset's 1% force contract


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
    from vistaf_torch.config import slice_ftp_config
    from vistaf_torch.ftp.pipeline import FTPGeometry
    from vistaf_torch.kernels import (ecc_loop_kernel, inpaint_kernel, polyfit_kernel,
                                      quantile_kernel)
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

    return [
        ("masked_quantiles", "vistaf_torch/csrc/quantile.cu",
         "vistaf_tpu/pallas/quantile_kernel.py:91",
         quantile_kernel.masked_quantiles, quantile_kernel.masked_quantiles_plain,
         k1_args, k1_check),
        ("inpaint_diffusion", "vistaf_torch/csrc/inpaint.cu",
         "vistaf_tpu/pallas/inpaint_kernel.py:94",
         inpaint_kernel.inpaint_diffusion, inpaint_kernel.inpaint_diffusion_plain,
         k3_args, k3_check),
        ("ecc_loop_euclidean", "vistaf_torch/csrc/ecc_loop.cu",
         "vistaf_tpu/pallas/ecc_loop_kernel.py:161",
         ecc_loop_kernel.ecc_loop_euclidean, ecc_loop_kernel.ecc_loop_euclidean_plain,
         k5_args, k5_check),
        ("robust_polyfit2d", "vistaf_torch/csrc/polyfit.cu",
         "vistaf_tpu/pallas/polyfit_kernel.py:144",
         polyfit_kernel.robust_polyfit2d_coef,
         polyfit_kernel.robust_polyfit2d_coef_plain, k7_args, k7_check),
    ]


def phase_kernels(device):
    import torch
    rows = []
    for name, source, replaces, kern, plain, args, check in kernel_cases(device):
        got = kern(*args)
        ref = plain(*args)
        torch.cuda.synchronize()
        err = check(got, ref)
        ms = cuda_ms(lambda: kern(*args))
        plain_ms = cuda_ms(lambda: plain(*args), reps=5, warmup=1)
        say("kernel", name=name, max_abs_err=err, ms=ms, plain_ms=plain_ms)
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": 0, "max_abs_err": err,
                     "ms": ms, "plain_ms": plain_ms})
    return rows


def phase_end_to_end(device, rows):
    import torch
    from vistaf_torch import kernels
    from vistaf_torch.config import ForceConfig, slice_ftp_config
    from vistaf_torch.pipelines.force import ForcePipeline
    from vistaf_torch.utils.synthetic import synthetic_pair

    cfg = slice_ftp_config(H, W)
    ref, de = synthetic_pair(H, W, cfg, seed=SEED)
    args = (cfg, ForceConfig(), P2H_MODEL, FORCE_MODEL)
    gpu = ForcePipeline(*args, debug_outputs=True, device=device)
    kernels.reset_launches()
    res = gpu(ref, de)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    for row in rows:
        row["launches"] = launches[row["name"]]
        assert row["launches"] > 0, f"{row['name']} was not launched on the main path"
    force = res["force_N"]
    assert np.isfinite(force) and force > 0.0, force
    hm = res["height_map_mm_crop"]
    roi = res["roi_eroded_crop"]
    assert hm.shape == roi.shape == (gpu.ftp.geom.crop_h, gpu.ftp.geom.crop_w)
    assert np.isfinite(hm[roi]).all()

    cpu = ForcePipeline(*args, debug_outputs=True, device="cpu")
    res_cpu = cpu(ref, de)
    gap = abs(force - res_cpu["force_N"]) / abs(res_cpu["force_N"])
    assert gap <= FORCE_RTOL, (force, res_cpu["force_N"])
    agree = float(np.mean(res["reliable_crop"] == res_cpu["reliable_crop"]))
    warp_gap = float(np.abs(res["dbg_ecc_warp"] - res_cpu["dbg_ecc_warp"])[:, 2].max())
    assert warp_gap < 0.05, warp_gap
    say("end_to_end", force_N=force, force_N_cpu=res_cpu["force_N"], force_gap=gap,
        reliable_agreement=agree, ecc_warp_gap_px=warp_gap,
        ecc_iters=int(res["dbg_ecc_iters"]), ecc_iters_cpu=int(res_cpu["dbg_ecc_iters"]),
        launches=launches)
    return ForcePipeline(*args, device=device), ref, de


def phase_timing(gpu, ref, de, card, frames: int = 40):
    import torch
    for _ in range(5):
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
    say("timing", frames=frames, p50_ms=p50, p90_ms=p90, fps=1000.0 / p50,
        host_syncs_per_frame=syncs, card=card)


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

    device = torch.device("cuda", 0)
    rows = phase_kernels(device)
    gpu, ref, de = phase_end_to_end(device, rows)
    phase_timing(gpu, ref, de, card)

    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
