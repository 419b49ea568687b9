"""Record the JAX package's results on every end-to-end path of chip_smoke.py.

    JAX_PLATFORMS=cpu python scripts/make_jax_record.py [--only PATH ...] [--out DIR]

Runs ``vistaf_tpu`` on the CPU through its normal entry points (jitted, as
the package runs itself) on exactly the inputs ``chip_smoke.py`` builds for
each path (its ``SEED``, calibration models and input helpers), and writes

- ``jax_record.json``: per path its configuration (``dataclasses.asdict``),
  the sha256 of every input array (``chip_smoke.input_digest``), the result
  scalars the gates read and the seconds it took; and the provenance (the
  JAX, jaxlib and numpy versions, the CPU);
- ``jax_record_maps.npz``: the boolean maps the gates compare, each
  ``np.packbits`` of the map (its shape is in the JSON), compressed.

into ``tests/fixtures/`` unless ``--out`` names another directory.  With
``--only`` just those paths run and the files hold only them; with
``--merge`` too, their entries and maps are added to the record already in
that directory (every other entry and map kept as it is, this run's
provenance under ``merged``).  Where a
Pallas kernel of the JAX package would run on the CPU, it runs as the JAX
tests run it: the fused temperature kernel in interpret mode under the
temperature deploy preset, every other kernel through the package's own
CPU route.  The thermochromic frame and the temperature weights are the
port's numpy helpers (the JAX package has none), carried across as plain
dataclasses.  The whole run takes ~25 minutes and ~6 GB on an 8-core CPU
(the 4K graphs compile for minutes each).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import platform
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

import chip_smoke as smoke  # noqa: E402

H, W, H4K, W4K = smoke.H, smoke.W, smoke.H4K, smoke.W4K
STAT_KEYS = ("mean_C", "median_C", "std_C", "min_C", "max_C", "valid_pixels")
FORCE_SCALARS = ("force_N", "volume_cm3", "contact_area_mm2", "max_depth_mm", "mm_per_px",
                 "estimated_grating_period_px")
FORCE_ARRAYS = ("dbg_global_shift", "dbg_ecc_warp", "dbg_ecc_rho", "dbg_ecc_iters",
                "carrier_k_ref", "carrier_k_def", "dbg_peak_ref")


def plain(x):
    """JSON form of a result value: numbers as Python numbers, arrays as
    nested lists."""
    a = np.asarray(x)
    if a.dtype == bool:
        return a.tolist()
    if np.issubdtype(a.dtype, np.integer):
        return a.astype(np.int64).tolist()
    return a.astype(np.float64).tolist()


def asdict(cfg):
    return json.loads(json.dumps(dataclasses.asdict(cfg)))


class Maps:
    """The boolean maps of the record: packed bits under ``path/name``."""

    def __init__(self):
        self.arrays = {}

    def add(self, entry, path, name, mask):
        mask = np.asarray(mask, bool)
        self.arrays[f"{path}/{name}"] = np.packbits(mask)
        entry.setdefault("maps", {})[name] = list(mask.shape)


# --------------------------------------------------------------- configs
def force_configs():
    """Each force path's JAX configuration and frame size, as chip_smoke.py
    builds the port's."""
    from vistaf_tpu.config import FTPConfig
    from vistaf_tpu.utils.synthetic import scaled_ftp_config
    out = {"640": (scaled_ftp_config(H, W).deploy(), H, W),
           "parity640": (scaled_ftp_config(H, W), H, W),
           "hist640": (scaled_ftp_config(H, W).replace(percentile_method="hist"), H, W),
           "4k": (FTPConfig().deploy(), H4K, W4K),
           "parity4k": (FTPConfig(), H4K, W4K)}
    for path, (deploy, change) in smoke.KNOBS_4K.items():
        base = FTPConfig().deploy() if deploy else FTPConfig()
        out[path] = (base.replace(**change), H4K, W4K)
    out["prealign640"] = (scaled_ftp_config(H, W).deploy().replace(
        use_grating_band_prealign=True), H, W)
    return out


TEMP_PATHS = {"temp4k": True, "temp4k_parity": False}        # path: deploy preset
MM_PATHS = {"mm4k": True, "mm4k_parity": False}
ORDER = smoke.JAX_PATHS


def temp_weights():
    """The port's seeded deploy-form weights and the JAX package's copies."""
    from vistaf_tpu.calib.temp_weights import TempModelWeights
    from vistaf_torch.utils.synthetic import synthetic_deploy_temp_weights
    color, wide = synthetic_deploy_temp_weights(smoke.SEED)
    return (color, wide), tuple(TempModelWeights(**dataclasses.asdict(m)) for m in (color, wide))


def weight_digests(models):
    return {k: smoke.input_digest(v) for k, v in smoke.model_arrays(models).items()}


def jax_temperature(deploy: bool):
    """(JAX TemperaturePipeline, its config, the port's config) under the
    deploy or the parity preset, the fused kernel in interpret mode where
    the preset asks for it."""
    from vistaf_tpu.config import TempConfig
    from vistaf_tpu.pallas.temp_kernel import make_fused_temperature_fn
    from vistaf_tpu.temperature.inference import TemperaturePipeline
    from vistaf_torch.config import temp_config_from_dict
    jcfg = TempConfig().deploy() if deploy else TempConfig()
    _, (jc, jw) = temp_weights()
    pipe = TemperaturePipeline(jcfg, jc, jw)
    if jcfg.use_fused_kernel:
        pipe._fused_fn = make_fused_temperature_fn(jcfg, jc, jw, interpret=True)
    return pipe, jcfg, temp_config_from_dict(dataclasses.asdict(jcfg))


# --------------------------------------------------------------- prealignment
class PrealignProbe:
    """Reads the prealignment's ECC warp out of the jitted JAX graph: while
    ``_grating_band_prealign`` traces, each ``ecc_align`` it calls reports
    its warp through a debug callback."""

    def __init__(self):
        import vistaf_tpu.ftp.pipeline as jpipe
        self.jpipe, self.warp, self.inside = jpipe, None, []
        self.raw_ecc = jpipe.ecc_align
        self.raw_pre = jpipe.FTPPipeline._grating_band_prealign

    def __enter__(self):
        probe = self

        def ecc(*a, **k):
            out = probe.raw_ecc(*a, **k)
            if probe.inside:
                jax.debug.callback(probe.store, out[0])
            return out

        def pre(pipe, *a, **k):
            probe.inside.append(True)
            try:
                return probe.raw_pre(pipe, *a, **k)
            finally:
                probe.inside.pop()

        self.jpipe.ecc_align, self.jpipe.FTPPipeline._grating_band_prealign = ecc, pre
        return self

    def store(self, w):
        self.warp = np.array(w)

    def __exit__(self, *exc):
        self.jpipe.ecc_align, self.jpipe.FTPPipeline._grating_band_prealign = \
            self.raw_ecc, self.raw_pre


# --------------------------------------------------------------- results
def force_result(res, entry, path, maps, prealign=None):
    out = {k: float(res[k]) for k in FORCE_SCALARS if k in res}
    out.update({k: plain(res[k]) for k in FORCE_ARRAYS})
    out["prealign_warp"] = None if prealign is None else plain(prealign)
    entry["result"] = out
    maps.add(entry, path, "reliable_crop", res["reliable_crop"])


def temperature_result(res, stats=None):
    roi = np.asarray(res["roi_outer"])
    out = {"seg_peak_xy": plain(res["seg_peak_xy"]),
           "color_share_of_roi": float(np.mean(np.asarray(res["source_map"])[roi] == 255))}
    for k in ("t_mean", "t_min", "t_max", "t_std", "valid_pixels"):
        out[k] = plain(res[k])
    if stats is not None:
        out["stats"] = {k: plain(stats[k]) for k in STAT_KEYS}
    return out


def record_force(path, jcfg, h, w, maps):
    from vistaf_tpu.config import ForceConfig
    from vistaf_tpu.pipelines.force import ForcePipeline
    from vistaf_tpu.utils.synthetic import synthetic_pair
    ref, de = synthetic_pair(h, w, jcfg, seed=smoke.SEED)
    entry = {"kind": "force", "shape": [h, w], "config": asdict(jcfg),
             "force_config": asdict(ForceConfig()),
             "inputs": {"ref": smoke.input_digest(ref), "def": smoke.input_digest(de)}}
    with PrealignProbe() as probe:
        res = ForcePipeline(jcfg, ForceConfig(), smoke.P2H_MODEL, smoke.FORCE_MODEL,
                            debug_outputs=True)(ref, de)
        jax.effects_barrier()
    if jcfg.use_grating_band_prealign:
        assert probe.warp is not None, path
    force_result(res, entry, path, maps, probe.warp if jcfg.use_grating_band_prealign else None)
    return entry


def record_temperature(path, deploy, maps):
    from vistaf_torch.utils.synthetic import synthetic_tlc_frame
    pipe, jcfg, tcfg = jax_temperature(deploy)
    frame = synthetic_tlc_frame(H4K, W4K, tcfg, smoke.SEED)
    (color, wide), _ = temp_weights()
    entry = {"kind": "temperature", "shape": [H4K, W4K], "config": asdict(jcfg),
             "inputs": {"frame": smoke.input_digest(frame), **weight_digests((color, wide))}}
    res = pipe(frame)
    entry["result"] = temperature_result(res)
    for k in smoke.TEMP_MASKS:
        maps.add(entry, path, k, res[k])
    return entry


def record_multimodal(path, deploy, maps):
    from vistaf_tpu.config import ForceConfig, FTPConfig
    from vistaf_tpu.pipelines.force import ForcePipeline
    from vistaf_tpu.pipelines.multimodal import MultimodalPipeline
    from vistaf_torch.config import ftp_config_from_dict
    tpipe, jtcfg, tcfg = jax_temperature(deploy)
    jfcfg = FTPConfig().deploy() if deploy else FTPConfig()
    ref, de = smoke.multimodal_inputs(ftp_config_from_dict(dataclasses.asdict(jfcfg)), tcfg)
    (color, wide), _ = temp_weights()
    entry = {"kind": "multimodal", "shape": [H4K, W4K], "config": asdict(jfcfg),
             "temp_config": asdict(jtcfg), "force_config": asdict(ForceConfig()),
             "inputs": {"ref": smoke.input_digest(ref), "def": smoke.input_digest(de),
                        **weight_digests((color, wide))}}
    force = ForcePipeline(jfcfg, ForceConfig(), smoke.P2H_MODEL, smoke.FORCE_MODEL,
                          debug_outputs=True)
    mm = MultimodalPipeline(force, tpipe)
    res = mm(ref, de)
    force_result(res["force"], entry, path, maps)
    entry["result"]["temperature"] = temperature_result(res["temperature"],
                                                        res["temperature_stats"])
    for k in smoke.TEMP_MASKS:
        maps.add(entry, path, k, res["temperature"][k])
    t0 = time.perf_counter()
    entry["result"]["scalars"] = {k: plain(v) for k, v in
                                  mm.step_fused(ref, de, fetch="scalars").items()}
    entry["step_fused_seconds"] = time.perf_counter() - t0
    return entry


def record_streams(maps):
    from vistaf_tpu.ftp.pipeline import FTPPipeline
    from vistaf_tpu.parallel.mesh import BatchedForce
    from vistaf_tpu.pipelines.streaming import StreamingForce
    from vistaf_tpu.utils.synthetic import scaled_ftp_config
    jcfg = scaled_ftp_config(H, W).deploy()
    _, refs, seq = smoke.stream_inputs()
    entry = {"kind": "streams", "shape": [H, W], "config": asdict(jcfg),
             "streams": smoke.STREAMS, "window": smoke.WINDOW, "ema_alpha": smoke.EMA_ALPHA,
             "inputs": {"refs": smoke.input_digest(refs),
                        **{f"batch{t}": smoke.input_digest(b) for t, b in enumerate(seq)}}}
    sf = StreamingForce(BatchedForce(FTPPipeline(jcfg, smoke.P2H_MODEL), smoke.FORCE_MODEL),
                        smoke.STREAMS, window=smoke.WINDOW, ema_alpha=smoke.EMA_ALPHA)
    outs = [sf(refs, b) for b in seq]
    entry["result"] = {k: [plain(o[k]) for o in outs] for k in sorted(outs[0])}
    return entry


def record_streams_parity(maps):
    """The parity preset's stream batch: the JAX ``BatchedForce.batched()``
    (``jit(vmap(_single))``) under ``scaled_ftp_config(H, W)`` on the first
    batch of ``chip_smoke.stream_inputs()``; and each stream's alignment
    (global shift, crop ECC), carrier bins and reliable mask from the JAX
    ForcePipeline with debug outputs, which the card's batch is given."""
    from vistaf_tpu.config import ForceConfig
    from vistaf_tpu.ftp.pipeline import FTPPipeline
    from vistaf_tpu.parallel.mesh import BatchedForce
    from vistaf_tpu.pipelines.force import ForcePipeline
    from vistaf_tpu.utils.synthetic import scaled_ftp_config
    jcfg = scaled_ftp_config(H, W)
    _, refs, seq = smoke.stream_inputs()
    defs = seq[0]
    entry = {"kind": "streams", "shape": [H, W], "config": asdict(jcfg),
             "streams": smoke.STREAMS,
             "inputs": {"refs": smoke.input_digest(refs), "defs": smoke.input_digest(defs)}}
    out = BatchedForce(FTPPipeline(jcfg, smoke.P2H_MODEL), smoke.FORCE_MODEL).batched()(
        refs, defs)
    res = {k: plain(v) for k, v in out.items() if k != "height_map_mm"}
    force = ForcePipeline(jcfg, ForceConfig(), smoke.P2H_MODEL, smoke.FORCE_MODEL,
                          debug_outputs=True)
    singles = [force(refs[b], defs[b]) for b in range(smoke.STREAMS)]
    res["streams"] = [{k: plain(o[k]) for k in FORCE_ARRAYS + ("force_N", "volume_cm3")}
                      for o in singles]
    entry["result"] = res
    maps.add(entry, "streams640_parity", "reliable_crop",
             np.stack([o["reliable_crop"] for o in singles]))
    return entry


def record_limb(maps):
    from jax.sharding import NamedSharding, PartitionSpec as P
    from vistaf_tpu.ftp.pipeline import FTPPipeline
    from vistaf_tpu.parallel import mesh as jmesh
    from vistaf_tpu.utils.synthetic import scaled_ftp_config
    jcfg = scaled_ftp_config(H, W).deploy()
    _, refs, defs, (pose, accel) = smoke.limb_inputs()
    entry = {"kind": "limb", "shape": [H, W], "config": asdict(jcfg),
             "map_stride": smoke.LIMB_STRIDE, "canvas": list(smoke.LIMB_CANVAS),
             "inputs": {k: smoke.input_digest(v) for k, v in
                        (("refs", refs), ("defs", defs), ("pose", pose), ("accel", accel))}}
    mesh = jmesh.make_stream_mesh(1)
    put = lambda x: jax.device_put(x, NamedSharding(mesh, P("stream")))  # noqa: E731
    bf = jmesh.BatchedForce(FTPPipeline(jcfg, smoke.P2H_MODEL), smoke.FORCE_MODEL)
    out = jmesh.whole_limb_step(bf, mesh, map_stride=smoke.LIMB_STRIDE)(put(refs), put(defs))
    aux = jmesh.whole_limb_step_aux(bf, mesh, smoke.LIMB_CANVAS, map_stride=smoke.LIMB_STRIDE)(
        put(refs), put(defs), {"pose_px": put(pose), "accel_mss": put(accel)})
    res = {k: plain(v) for k, v in out.items() if k != "whole_limb_map_mm"}
    limb = np.asarray(out["whole_limb_map_mm"])
    res["map_max"] = plain(limb.max(axis=(1, 2)))
    res["map_sum"] = plain(limb.astype(np.float64).sum(axis=(1, 2)))
    res["aux"] = {k: plain(v) for k, v in aux.items() if k != "limb_canvas_mm"}
    res["aux"]["canvas_max"] = float(np.asarray(aux["limb_canvas_mm"]).max())
    entry["result"] = res
    maps.add(entry, "limb640", "contact", limb > 0)
    return entry


def provenance():
    import jaxlib
    cpu = platform.processor() or platform.machine()
    try:
        with open("/proc/cpuinfo") as f:
            names = [ln.split(":", 1)[1].strip() for ln in f if ln.startswith("model name")]
        cpu = names[0] if names else cpu
    except OSError:
        pass
    return {"script": "scripts/make_jax_record.py", "jax": jax.__version__,
            "jaxlib": jaxlib.__version__, "numpy": np.__version__,
            "python": platform.python_version(), "backend": jax.default_backend(),
            "cpu": cpu, "cpu_count": os.cpu_count(), "seed": smoke.SEED}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", nargs="*", choices=ORDER, help="paths to run (default: all)")
    ap.add_argument("--out", default=os.path.join(ROOT, "tests", "fixtures"))
    ap.add_argument("--merge", action="store_true",
                    help="add the paths run to the record in --out")
    args = ap.parse_args(argv)
    forces = force_configs()
    maps, paths = Maps(), {}
    t_all = time.perf_counter()
    for path in (args.only or ORDER):
        t0 = time.perf_counter()
        if path in forces:
            entry = record_force(path, *forces[path], maps)
        elif path in TEMP_PATHS:
            entry = record_temperature(path, TEMP_PATHS[path], maps)
        elif path in MM_PATHS:
            entry = record_multimodal(path, MM_PATHS[path], maps)
        elif path == "streams640":
            entry = record_streams(maps)
        elif path == "streams640_parity":
            entry = record_streams_parity(maps)
        else:
            entry = record_limb(maps)
        entry["seconds"] = time.perf_counter() - t0
        paths[path] = entry
        print(json.dumps({"path": path, "seconds": entry["seconds"]}), flush=True)
        jax.clear_caches()
    record = {"provenance": {**provenance(), "seconds": time.perf_counter() - t_all},
              "maps": "jax_record_maps.npz", "paths": paths}
    if args.merge:
        with open(os.path.join(args.out, "jax_record.json")) as f:
            old = json.load(f)
        with np.load(os.path.join(args.out, old["maps"])) as z:
            arrays = {k: z[k] for k in z.files if k.split("/")[0] not in paths}
        old["provenance"].setdefault("merged", []).append(
            {**record["provenance"], "paths": sorted(paths)})
        record = {**old, "paths": {**old["paths"], **paths}}
        maps.arrays = {**arrays, **maps.arrays}
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "jax_record.json"), "w") as f:
        json.dump(record, f, indent=1, sort_keys=True)
        f.write("\n")
    np.savez_compressed(os.path.join(args.out, "jax_record_maps.npz"), **maps.arrays)
    return 0


if __name__ == "__main__":
    sys.exit(main())
