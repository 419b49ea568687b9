"""Command-line entry points of the port (JAX ``runner/cli.py``).

The same subcommands, arguments and defaults as the JAX CLI, run by the
port's pipelines and trainers; each subcommand also takes ``--device``
(default ``cuda``, the card; ``cpu`` runs the kernels' plain versions):

    python -m vistaf_torch.runner.cli force --ref R.jpg --def D.jpg --out out/
    python -m vistaf_torch.runner.cli temperature --image D.jpg --out out/
    python -m vistaf_torch.runner.cli multimodal --ref R.jpg --def D.jpg
    python -m vistaf_torch.runner.cli train-p2h --ref R.jpg --deformed-dir D --out out/
    python -m vistaf_torch.runner.cli train-h2f --ref R.jpg --deformed-dir D \
        --p2h-json out/calibration_model.json --out out2/
    python -m vistaf_torch.runner.cli train-temp-color --heating 'H/heating-*.jpg' \
        --cooling 'C/cooling-*.jpg' --out out/      (also train-temp-black)
    python -m vistaf_torch.runner.cli pretest --pattern 'S/*.jpg' --out out/
"""
from __future__ import annotations

import argparse
import json
import os
import sys


def _add_data_root(p):
    p.add_argument("--data-root", default=".",
                   help="root containing the reference-layout calibration artifacts")


def _add_preset(p):
    p.add_argument("--preset", default="parity", choices=["parity", "deploy"],
                   help="'parity' = reference-faithful numerics (default); "
                        "'deploy' = latency-oriented preset "
                        "(FTPConfig.deploy()/TempConfig.deploy(): the fused "
                        "kernels, shear rotation, ROI-crop compute)")


def _add_device(p):
    p.add_argument("--device", default="cuda",
                   help="PyTorch device the pipelines and trainers run on (default: "
                        "cuda, the card; cpu runs the kernels' plain versions)")


def _cfgs(args):
    from vistaf_torch.config import FTPConfig, TempConfig
    if getattr(args, "preset", "parity") == "deploy":
        return FTPConfig().deploy(), TempConfig().deploy()
    return FTPConfig(), TempConfig()


def _device(args):
    """The subcommand's device; on the card, float32 products in full
    float32.  A CUDA device without a card raises: nothing falls back."""
    import torch
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"--device {args.device}: CUDA is not available "
                               "(pass --device cpu to run on the CPU)")
        from vistaf_torch import use_full_fp32
        use_full_fp32()
    return device


def cmd_force(args) -> int:
    from vistaf_torch.pipelines.force import ForcePipeline
    from vistaf_torch.runner import io

    debug = bool(getattr(args, "debug", False))
    ftp_cfg, _ = _cfgs(args)
    pipe = ForcePipeline.from_artifacts(args.data_root, ftp_cfg=ftp_cfg,
                                        debug_outputs=debug, device=_device(args))
    ref = io.imread_bgr(args.ref)
    de = io.imread_bgr(getattr(args, "def"))
    out = pipe(ref, de)
    ftp_dir = os.path.join(args.out, "ftp_run")
    io.ensure_dir(ftp_dir)
    if debug:
        from vistaf_torch.runner.debug_artifacts import write_ftp_debug
        write_ftp_debug(ftp_dir, out, pipe.ftp.cfg, apo=pipe.ftp._apo)
    io.write_force_result(args.out, out, pipe.force_model, args.ref,
                          getattr(args, "def"), ftp_dir,
                          pipe.force_cfg.grating_pitch_mm, pipe.force_cfg.depth_eps_mm)
    if args.export_heightmaps:
        io.export_heightmap_files(ftp_dir, "height_map", out["height_map_mm_crop"])
    if getattr(args, "show_3d", False):
        from vistaf_torch.runner import figures
        figures.show_heightmap_3d_interactive(
            out["height_map_mm_crop"], out["roi_eroded_crop"],
            f"Height map (interactive 3D) - Force: {out['force_N']:.2f} N")
    print(f"volume_cm3    = {out['volume_cm3']:.6g}")
    print(f"force_N       = {out['force_N']:.6g}")
    print(f"max_depth_mm  = {out['max_depth_mm']:.6g}")
    print(f"saved         = {os.path.join(args.out, 'result.json')}")
    return 0


def cmd_temperature(args) -> int:
    import numpy as np
    from vistaf_torch.temperature.inference import TemperaturePipeline
    from vistaf_torch.runner import io, figures

    _, temp_cfg = _cfgs(args)
    pipe = TemperaturePipeline.from_artifacts(args.data_root, cfg=temp_cfg,
                                              device=_device(args))
    img = io.imread_bgr(args.image)
    out = pipe(img)
    io.ensure_dir(args.out)
    if bool(getattr(args, "debug", False)):
        from vistaf_torch.runner.debug_artifacts import write_temperature_debug
        write_temperature_debug(args.out, img, out, bbox=out["crop_bbox"])
    np.save(os.path.join(args.out, "temperature_map_fused.npy"),
            out["temperature_map_fused"].astype(np.float32))
    np.save(os.path.join(args.out, "temperature_map_final.npy"),
            out["temperature_map_final"].astype(np.float32))
    bbox = out["crop_bbox"]
    for name, key in [("mask_roi.png", "roi_full"), ("mask_roi_eff.png", "mask_roi_eff"),
                      ("mask_sat.png", "mask_sat"), ("mask_dark.png", "mask_dark"),
                      ("mask_light.png", "mask_light"),
                      ("mask_color_support.png", "mask_color_support"),
                      ("mask_color_ok.png", "mask_color_ok")]:
        io.write_mask_png(os.path.join(args.out, name), out[key], bbox)
    cfg = pipe.cfg
    stats_roi = out["roi_outer"] if cfg.crop_output_to_outer_roi else out["roi_full"]
    title = f"Temperature map - min: {out['t_min']:.2f} °C, max: {out['t_max']:.2f} °C"
    figures.save_temperature_colormap(args.out, io.crop2d(out["temperature_map_final"], bbox),
                                      io.crop2d(stats_roi, bbox),
                                      "temperature_map_final_colormap.png",
                                      cfg.final_t_min, cfg.final_t_max, title=title)
    figures.save_temperature_overlay(args.out, io.crop2d(img, bbox),
                                     io.crop2d(out["temperature_map_final"], bbox),
                                     io.crop2d(stats_roi, bbox),
                                     "temperature_map_final_colormap_overlay.png",
                                     cfg.final_t_min, cfg.final_t_max)
    figures.save_horizontal_legend(args.out, cfg.final_t_min, cfg.final_t_max)
    # the reference writes the raw-prediction/fused artifact set
    # unconditionally (temperature_sensor.py:873-927)
    from vistaf_torch.runner.debug_artifacts import write_temperature_raw_maps
    write_temperature_raw_maps(args.out, img, out, cfg, bbox=bbox)
    print(f"Final temperature min/max in ROI: {out['t_min']:.3f} / {out['t_max']:.3f} °C")
    print(f"Saved outputs to: {os.path.abspath(args.out)}")
    return 0


def cmd_multimodal(args) -> int:
    from vistaf_torch.config import SessionConfig
    from vistaf_torch.pipelines.multimodal import MultimodalPipeline
    from vistaf_torch.runner.session import run_session

    ftp_cfg, temp_cfg = _cfgs(args)
    pipe = MultimodalPipeline.from_artifacts(args.data_root, ftp_cfg=ftp_cfg,
                                             temp_cfg=temp_cfg, device=_device(args))
    cfg = SessionConfig(output_root=args.out,
                        show_3d_interactive=getattr(args, "show_3d", False),
                        fused_step=getattr(args, "fused", False))
    summary = run_session(pipe, args.ref, getattr(args, "def"), args.data_root, cfg)
    sr = summary["sensor_readings"]
    print(f"Force:       {sr['force']['force_N']:.3f} N")
    print(f"Temperature: {sr['temperature']['mean_C']:.2f} ± {sr['temperature']['std_C']:.2f} °C")
    print(f"Session:     {summary['output_directory']}")
    return 0


def cmd_train_p2h(args) -> int:
    from vistaf_torch.trainers import phase_to_height as t
    out = t.train(args.ref, t.DEFAULT_CALIBRATION_SAMPLES, args.deformed_dir, args.out,
                  device=_device(args))
    print(json.dumps(out["best_model"], indent=2))
    return 0


def cmd_train_h2f(args) -> int:
    from vistaf_torch.calib.artifacts import load_phase_to_height
    from vistaf_torch.trainers import height_to_force as t
    device = _device(args)
    p2h, use_neg = load_phase_to_height(args.p2h_json)
    out = t.train(args.ref, args.deformed_dir, args.out, p2h, use_neg, device=device)
    print(json.dumps(out["best_model"], indent=2))
    return 0


def cmd_train_temp_color(args) -> int:
    from vistaf_torch.trainers import temperature_color as t
    out = t.train(args.heating, args.cooling, args.out, device=_device(args))
    print(json.dumps({k: v["metrics_means"] for k, v in out["models_final"].items()}, indent=2))
    return 0


def cmd_train_temp_black(args) -> int:
    from vistaf_torch.trainers import temperature_black as t
    out = t.train(args.heating, args.cooling, args.out, device=_device(args))
    print(json.dumps({k: v["metrics_means"] for k, v in out["models_final"].items()}, indent=2))
    return 0


def cmd_pretest(args) -> int:
    import cv2
    import numpy as np
    from vistaf_torch.trainers import pretest
    device = _device(args)
    files = pretest.load_series_sorted(args.pattern)
    img = cv2.imread(files[0], cv2.IMREAD_COLOR)
    h, w = img.shape[:2]
    if args.roi == "full":
        mask = np.ones((h, w), bool)
    else:
        from vistaf_torch.config import TempConfig
        from vistaf_torch.ops import geometry
        cfg = TempConfig()
        c = geometry.circle_from_3_points_exact(cfg.outer_circle_p1, cfg.outer_circle_p2,
                                                cfg.outer_circle_p3)
        mask = geometry.circular_mask(h, w, *c)
    out = pretest.analyze(args.pattern, mask, dt_s=args.dt, out_dir=args.out,
                          label=args.label, device=device)
    print(json.dumps(out["stabilization"], indent=2))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="vistaf-torch", description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("force", help="frame pair -> force (force_sensor.py)")
    p.add_argument("--ref", required=True)
    p.add_argument("--def", required=True)
    p.add_argument("--out", default="./force_sensor_out")
    p.add_argument("--export-heightmaps", action="store_true")
    p.add_argument("--show-3d", dest="show_3d", action="store_true",
                   help="open the interactive 3-D heightmap window "
                        "(force_sensor.py SHOW_3D)")
    p.add_argument("--debug", action="store_true",
                   help="write the reference DEBUG_* figure set + debug_log.txt")
    _add_data_root(p)
    _add_preset(p)
    _add_device(p)
    p.set_defaults(fn=cmd_force)

    p = sub.add_parser("temperature", help="frame -> temperature map (temperature_sensor.py)")
    p.add_argument("--image", required=True)
    p.add_argument("--out", default="./temp_inference")
    p.add_argument("--debug", action="store_true",
                   help="write debug_{seg_overlay,fft_mag,chroma_u8}.png")
    _add_data_root(p)
    _add_preset(p)
    _add_device(p)
    p.set_defaults(fn=cmd_temperature)

    p = sub.add_parser("multimodal", help="frame pair -> full session (multimodal_sensor.py)")
    p.add_argument("--ref", required=True)
    p.add_argument("--def", required=True)
    p.add_argument("--out", default="./Multimodal_Sensor/run_output")
    p.add_argument("--show-3d", dest="show_3d", action="store_true",
                   help="open the interactive 3-D heightmap window "
                        "(multimodal_sensor.py SHOW_3D_HEIGHTMAP_INTERACTIVE)")
    p.add_argument("--fused", action="store_true",
                   help="MultimodalPipeline.step_fused: both forwards on shared "
                        "uploads with the force reduced on the device (same outputs)")
    _add_data_root(p)
    _add_preset(p)
    _add_device(p)
    p.set_defaults(fn=cmd_multimodal)

    p = sub.add_parser("train-p2h", help="phase->height calibration (phase_to_height.py)")
    p.add_argument("--ref", required=True)
    p.add_argument("--deformed-dir", required=True)
    p.add_argument("--out", required=True)
    _add_device(p)
    p.set_defaults(fn=cmd_train_p2h)

    p = sub.add_parser("train-h2f", help="volume->force calibration (height_to_force.py)")
    p.add_argument("--ref", required=True)
    p.add_argument("--deformed-dir", required=True)
    p.add_argument("--p2h-json", required=True)
    p.add_argument("--out", required=True)
    _add_device(p)
    p.set_defaults(fn=cmd_train_h2f)

    p = sub.add_parser("train-temp-color", help="colored-TLC models (temperature_color_model.py)")
    p.add_argument("--heating", required=True)
    p.add_argument("--cooling", required=True)
    p.add_argument("--out", required=True)
    _add_device(p)
    p.set_defaults(fn=cmd_train_temp_color)

    p = sub.add_parser("train-temp-black", help="black-TLC models (temperature_black_model.py)")
    p.add_argument("--heating", required=True)
    p.add_argument("--cooling", required=True)
    p.add_argument("--out", required=True)
    _add_device(p)
    p.set_defaults(fn=cmd_train_temp_black)

    p = sub.add_parser("pretest", help="thermal stabilization time (pretest_*.py)")
    p.add_argument("--pattern", required=True)
    p.add_argument("--dt", type=float, default=20.0)
    p.add_argument("--roi", default="outer", choices=["outer", "full"])
    p.add_argument("--out", default=None,
                   help="directory for Figure_1_pretest_<label>.png")
    p.add_argument("--label", default="series")
    _add_device(p)
    p.set_defaults(fn=cmd_pretest)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
