"""Benchmark of the PyTorch + CUDA port (``vistaf_torch``) on one NVIDIA GPU:
the counterpart of the JAX package's ``bench.py`` and of its
``scripts/bench_{4k,mm,streams,config23,ingest}.py``.

    python3 bench_torch.py                 # bench.py's row: 640x480 frame->force
    python3 bench_torch.py SUITE [--out rows.json] [--rounds R] [--iters N]
                           [--rows ROW ...]

SUITE is ``default`` (the same as no argument), ``4k``, ``mm``,
``streams``, ``config23``, ``ingest`` or ``all`` (every suite, ``default``
last).  Each row prints one JSON line on standard output; ``--out`` also
writes the rows as one JSON list; ``--rows`` keeps only the named rows of
the suite (one row a process times it before any other row's profiled
window: once ``torch.profiler`` has traced the card, graph replays in the
process run faster).  The last line of ``default`` (and of
``all``) is ``bench.py``'s own line: ``metric``, ``value`` (frames/s = 1000
/ p50), ``unit``, ``vs_baseline`` (value over the reference CPU
implementation's 640x480 rate cached in ``bench_baseline.json``) and the
statistics.  Without CUDA the script says why on standard error and exits
1; it has no CPU fallback.

Rows (synthetic inputs, made from ``chip_smoke.SEED`` by ``chip_smoke``'s
own input builders, so that each row's output can be held to the JAX
record ``tests/fixtures/jax_record.json``):

- ``default`` (``bench.py``): ``640``, BASELINE config 1
  (``slice_ftp_config(480, 640)``): what ``bench.py::measure_tpu``'s ``fn``
  computes, from frames already on the card: the forward,
  ``depth_map_to_volume_cm3`` over the finite heightmap and
  ``predict_force_from_volume``, the force fetched to the host; then
  ``640_call``, ``ForcePipeline.__call__`` from numpy frames.
- ``4k`` (``scripts/bench_4k.py``): the same function under
  ``FTPConfig().deploy()`` (``4k``) and ``FTPConfig()`` (``parity4k``) at
  2160x3840, ``prealign4k`` (the deploy preset with the grating-band
  prealignment and the single-pass detrend) and ``parity640``
  (``scaled_ftp_config(480, 640)``).
- ``mm`` (``scripts/bench_mm.py``), under the deploy presets (``mm4k``)
  and the parity presets (``mm4k_parity``) at 2160x3840 on
  ``chip_smoke.multimodal_inputs``: the force alone and the temperature
  forward alone from frames on the card, each ending in a scalar fetch,
  ``MultimodalPipeline.__call__`` and ``step_fused(fetch="scalars")``
  from numpy frames.
- ``streams`` (``scripts/bench_streams.py``): config 4 (``streams640``:
  ``StreamingForce``, 4 streams at 640x480, window 8, a batch on the
  card), config 5 (``limb640``, ``limb640_aux``: ``whole_limb_step`` and
  ``whole_limb_step_aux`` on a world-1 NCCL mesh, the step's Hz against
  config 5's 200 Hz), the 2160x3840 temperature path's ``__call__`` and
  ``.stats()`` under ``TempConfig().deploy()`` (``temp4k``) and
  ``TempConfig()`` (``temp4k_parity``), and ``hist640`` (the 640 force
  under ``percentile_method="hist"``).
- ``config23`` (``scripts/bench_config23.py``): BASELINE configs 2 and 3,
  ``ForcePipeline.contact_classification_device`` and
  ``force_map_device`` at 640x480 deploy from frames on the card.
- ``ingest`` (``scripts/bench_ingest.py``), on the 2160x3840 multimodal
  deploy pair written as JPEGs: the decode (``runner/io.py::imread_bgr``,
  the cv2 decode ``iter_images_bgr`` takes where the native decoder is not
  built); one 24 MB frame's upload from pageable and from pinned memory,
  with GB/s; camera->force serialized per frame (decode, upload, the
  deploy forward and the scalar fetch); ``MultimodalPipeline`` given one
  pinned upload (``ingest``) against the two pipelines given the numpy
  frame (two pageable uploads) and ``step_fused(fetch="scalars")``; and
  six ``streams640`` batches through ``StreamingForce.run_overlapped``
  against the same batches serialized.

Timing (``run_rows``): the kernels are built first (``kernels.build()``,
as ``chip_smoke.py`` does); each row's function is called once for its
gate and ``warmup - 1`` more times untimed; then R rounds of N calls, each
call between two CUDA events with ``torch.cuda.synchronize()`` after the
second (``profiling.event_times``), the profiler and sync debug mode off.
Rows of one group (the uploads, the multimodal ingest variants, the stream
sequences) are timed in turns, round by round.  ``p50_ms`` is the median
of the round medians; ``tail_ms`` the 90th percentile of all samples from
100 samples on, else the highest percentile with at least ten samples
beyond it, named in ``tail``; ``round_medians_ms`` and ``spread_ms`` show
the rounds' noise.  Then, apart from the timing: the host syncs of one
call (sync debug mode) and the hand-written kernels it launched
(``kernels.LAUNCHES``), and a profiled window of a few calls
(``profiling.profile_window``: device busy ms and share, launches, the
heaviest device work, device-to-host copies), each per call.

Route: every row's line says how its forwards run: ``route`` is ``graph``
where each replays a CUDA graph (the ``graph_route`` of the row's
``FTPPipeline``, ``TemperaturePipeline``, ``MultimodalPipeline``,
``StreamingForce`` or whole-limb step: every forward on the card, the force
forward's ECC and PCG loops and its seed pick, and the temperature
forward's shear fold, as conditional nodes; ``step_fused`` one graph of
both forwards; a stream batch's step or a limb step one graph of its
streams, smoothing or head), else ``eager`` (the rows with no forward:
decode, uploads).  A stream batch is one batched forward (``jax.vmap``)
under every configuration.  The profiled window counts the graph replays (``graph_launches_per_frame``)
apart from the kernel launches.

Correctness: each row holds its output to its gate once, before timing,
and prints ``correct``; the script exits 1 if any row fails.  Rows on a
path of the JAX record use ``chip_smoke``'s gates: the inputs' sha256
(``check_jax_inputs``), a debug run free-running and given JAX's
alignment (``hold_force_to_jax``), force within 1% (``FORCE_RTOL``; only
reported where ``JAX_UNDETERMINED`` names 'free'), temperature t_mean 0.1
degC, t_min/t_max 0.75 degC, valid pixels 0.5%, masks and seg peak
(``hold_temperature_to_jax``), streams and limb (``hold_streams_to_jax``,
``hold_limb_to_jax``).  Rows off the record are held to the port's own
direct calls on the same frames (``CALL_RTOL``), or bit for bit where both
sides run the same forward.

Left out: ``bench_4k.py``'s FINAL_E golden force (3.296 N) and its five
golden scenes, ``bench.py``'s re-time of the reference CPU implementation
and the JAX scripts' demo frames need the reference data root (the demo
images, ``Demos_report`` and the reference code), which this repository
does not carry; the native libjpeg decode needs libjpeg where the bench
runs (the row reports which decoder ran).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import tempfile
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

import chip_smoke as smoke
from vistaf_torch import kernels
from vistaf_torch.calib import scalar_models
from vistaf_torch.config import ForceConfig, FTPConfig, TempConfig
from vistaf_torch.pipelines.force import ForcePipeline, depth_map_to_volume_cm3
from vistaf_torch.utils import profiling

HERE = os.path.dirname(os.path.abspath(__file__))
# the reference CPU implementation's 640x480 frames/s, measured once by the
# JAX package's bench.py (its cache)
with open(os.path.join(HERE, "bench_baseline.json")) as _f:
    BASELINE_FPS = json.load(_f)["reference_cpu_fps_640x480"]
SUITES = ("4k", "mm", "streams", "config23", "ingest", "default")   # the order of ``all``
CONFIG5_HZ = 200.0         # BASELINE config 5: the whole-limb map at 200 Hz
# the device surfaces of configs 2 and 3 and the camera->force row against
# ForcePipeline.__call__ on the same frames: the same forward, but __call__
# squares mm_per_px on the host (float64, then float32) where the surfaces
# square it on the device in float32
CALL_RTOL = 1e-5


class Timing(NamedTuple):
    """Rounds, calls a round, warm-up calls (the gate's call is the first)
    and calls in the profiled window (0: host-only work, not profiled)."""
    rounds: int
    iters: int
    warmup: int
    profile: int


# by the time a call takes: ~0.1 s (640x480, a 4K temperature frame, an
# upload), ~0.3 s (2160x3840 force and multimodal, a stream batch, a limb
# step), a whole sequence of stream batches.  Every row has a warm-up call
# past its gate: a graph-routed pipeline's first call captures its graph,
# and the sequences' gates run on pipelines of their own
FAST, SLOW, SEQUENCE = Timing(5, 20, 3, 3), Timing(5, 6, 2, 1), Timing(4, 2, 2, 1)
# what a suite leaves to undo once its rows have run (a temporary directory,
# the stream mesh's process group)
CLEANUP: List[Callable[[], None]] = []


@dataclass
class Row:
    """One bench row: ``fn`` is what is timed; ``gate()`` runs once before
    the timing (it may call ``fn``: that call is the first warm-up) and
    returns what it compared, raising AssertionError where the output
    fails; ``rates(p50_ms)`` adds the metrics derived from the p50; rows of
    one ``group`` are timed in turns."""
    name: str
    what: str
    fn: Callable[[], Any]
    gate: Callable[[], Dict[str, Any]]
    timing: Timing = FAST
    rates: Optional[Callable[[float], Dict[str, Any]]] = None
    group: Optional[str] = None
    # the pipelines whose forwards the row runs (each with ``graph_route``)
    routed: Tuple[Any, ...] = ()


def forward_route(routed) -> Dict[str, Any]:
    """``route``: 'graph' where every forward of the row replays a CUDA
    graph (the ``graph_route`` of its ``FTPPipeline``,
    ``TemperaturePipeline``, ``MultimodalPipeline``, ``StreamingForce`` or
    whole-limb step), else 'eager' (on
    the CPU, and rows with no forward)."""
    graph = bool(routed) and all(p.graph_route() for p in routed)
    return {"route": "graph" if graph else "eager"}


def fps(p50_ms: float) -> Dict[str, float]:
    return {"fps": 1000.0 / p50_ms}


def _jsonable(x):
    if isinstance(x, (np.generic, np.ndarray, torch.Tensor)):
        return x.tolist()
    raise TypeError(f"{type(x).__name__} is not JSON serializable")


def dumps(obj) -> str:
    return json.dumps(obj, default=_jsonable)


# ---------------------------------------------------------------------------
# force rows
# ---------------------------------------------------------------------------
def force_args(cfg):
    return (cfg, ForceConfig(), smoke.P2H_MODEL, smoke.FORCE_MODEL)


def force_inputs(path: str):
    """(ForcePipeline arguments, ref, def) of a force path as
    ``chip_smoke.run_path`` builds them."""
    from vistaf_torch.utils.synthetic import synthetic_pair
    cfg, h, w = smoke.force_path_configs()[path]
    ref, de = synthetic_pair(h, w, cfg, seed=smoke.SEED)
    return force_args(cfg), ref, de


def device_force(pipe: ForcePipeline, ref, de) -> float:
    """``bench.py::measure_tpu``'s ``fn`` on the port: the forward, the
    volume over the finite heightmap and the force model on the pipeline's
    device, the force fetched to the host."""
    out = pipe.ftp.forward(ref, de)
    height = out["height_map_mm_crop"]
    v, _, _ = depth_map_to_volume_cm3(height, torch.isfinite(height),
                                      pipe.mm_per_px_device(out["est_period_px"]),
                                      pipe.force_cfg.depth_eps_mm)
    return float(scalar_models.predict_force_from_volume(pipe.force_model, v, xp=torch))


def hold_force(path: str, args, ref, de, device, roi_from_finite: bool = False,
               inputs=None) -> Dict[str, Any]:
    """``chip_smoke``'s ``jax`` line of a force path: a debug run on
    ``device`` held to the JAX record free-running and given JAX's
    alignment (``hold_force_to_jax``, which asserts its gates)."""
    pipe = ForcePipeline(*args, debug_outputs=True, device=device)
    prealign = smoke.capture_prealign(pipe)
    res = pipe(ref, de, roi_from_finite=roi_from_finite)
    return smoke.hold_force_to_jax(path, args, ref, de, res, device,
                                   prealign[0] if prealign else None,
                                   roi_from_finite=roi_from_finite, inputs=inputs)


def force_gap(path: str, force: float) -> Dict[str, Any]:
    """A row's force against the JAX record's: within FORCE_RTOL, unless
    JAX_UNDETERMINED names 'free' for the path (then reported)."""
    want = smoke.jax_record()[0][path]["result"]["force_N"]
    gap = smoke.rel_gap(force, want)
    gated = "free" not in smoke.JAX_UNDETERMINED.get(path, ())
    if gated:
        assert gap <= smoke.FORCE_RTOL, (path, force, want)
    return {"force_N": force, "force_N_jax": want, "force_gap": gap, "force_gated": gated}


def force_row(path: str, device, timing=FAST, what=None) -> Row:
    """``device_force`` on a force path of ``chip_smoke.force_path_configs``,
    its frames on the device, held to the JAX record."""
    args, ref, de = force_inputs(path)
    pipe = ForcePipeline(*args, device=device)
    r, d = pipe.ftp.upload(ref), pipe.ftp.upload(de)

    def gate():
        line = hold_force(path, args, ref, de, device)
        return {"against": "jax_record", **force_gap(path, device_force(pipe, r, d)),
                "jax": line}
    return Row(path, what or f"frame->force ({path}): forward + volume + force model, frames "
               "on the device, the force fetched", lambda: device_force(pipe, r, d), gate,
               timing, fps, routed=(pipe.ftp,))


def suite_default(device) -> List[Row]:
    args, ref, de = force_inputs("640")
    pipe = ForcePipeline(*args, device=device)

    def gate_call():
        smoke.check_jax_inputs("640", ref=ref, **{"def": de})
        return {"against": "jax_record", **force_gap("640", pipe(ref, de)["force_N"])}
    call = Row("640_call", "ForcePipeline.__call__ from numpy frames (BASELINE config 1): "
               "uploads, forward, every map to the host", lambda: pipe(ref, de), gate_call,
               FAST, fps, routed=(pipe.ftp,))
    head = force_row("640", device, what="bench.py: 640x480 frame->force (BASELINE config "
                     "1), frames on the device, the force fetched")
    return [head, call]


def suite_4k(device) -> List[Row]:
    return [force_row("4k", device, SLOW), force_row("parity4k", device, SLOW),
            force_row("prealign4k", device, SLOW), force_row("parity640", device)]


# ---------------------------------------------------------------------------
# temperature and multimodal rows
# ---------------------------------------------------------------------------
def stats_gaps(path: str, got: Dict[str, float]) -> Dict[str, Any]:
    """Scene scalars (t_mean, t_min, t_max, valid_pixels) against the JAX
    record's (its temperature part on a multimodal path), with the
    temperature contract of ``chip_smoke``: t_mean within T_MEAN_ATOL,
    t_min and t_max within T_EXTREME_ATOL, valid pixels within VALID_RTOL."""
    rec = smoke.jax_record()[0][path]["result"]
    rec = rec.get("temperature", rec)
    gaps = {f"{k}_gap": abs(float(got[k]) - rec[k]) for k in ("t_mean", "t_min", "t_max")}
    gaps["valid_pixels_gap"] = abs(int(got["valid_pixels"]) - rec["valid_pixels"]) \
        / rec["valid_pixels"]
    assert gaps["t_mean_gap"] <= smoke.T_MEAN_ATOL, (path, gaps)
    assert max(gaps["t_min_gap"], gaps["t_max_gap"]) <= smoke.T_EXTREME_ATOL, (path, gaps)
    assert gaps["valid_pixels_gap"] <= smoke.VALID_RTOL, (path, gaps)
    return gaps


def temperature_rows(device, cfg, path: str) -> List[Row]:
    """``__call__`` and ``.stats()`` of the 2160x3840 temperature path on
    ``chip_smoke``'s frame and models, from a numpy frame."""
    from vistaf_torch.temperature.inference import TemperaturePipeline
    from vistaf_torch.utils.synthetic import synthetic_deploy_temp_weights, synthetic_tlc_frame
    color, wide = synthetic_deploy_temp_weights(smoke.SEED)
    frame = synthetic_tlc_frame(smoke.H4K, smoke.W4K, cfg, smoke.SEED)
    tp = TemperaturePipeline(cfg, color, wide, device=device)

    def gate_call():
        line = smoke.hold_temperature_to_jax(path, tp(frame), frame=frame, models=(color, wide))
        return {"against": "jax_record", "jax": line}

    def gate_stats():
        smoke.check_jax_inputs(path, frame=frame, **smoke.model_arrays((color, wide)))
        return {"against": "jax_record", **stats_gaps(path, tp.stats(frame))}
    return [Row(path, f"TemperaturePipeline.__call__ ({path}) from a numpy frame, every map "
                "to the host", lambda: tp(frame), gate_call, FAST, fps, routed=(tp,)),
            Row(f"{path}_stats", f"TemperaturePipeline.stats ({path}) from a numpy frame, "
                "one scalar fetch", lambda: tp.stats(frame), gate_stats, FAST, fps,
                routed=(tp,))]


def multimodal_rows(device, path: str, fcfg, tcfg) -> List[Row]:
    from vistaf_torch.pipelines.multimodal import MultimodalPipeline, temperature_stats
    from vistaf_torch.temperature.inference import TemperaturePipeline
    from vistaf_torch.utils.synthetic import synthetic_deploy_temp_weights
    ref, de = smoke.multimodal_inputs(fcfg, tcfg)
    color, wide = synthetic_deploy_temp_weights(smoke.SEED)
    models = smoke.model_arrays((color, wide))
    args = force_args(fcfg)
    force = ForcePipeline(*args, device=device)
    temp = TemperaturePipeline(tcfg, color, wide, device=device)
    mm = MultimodalPipeline(force, temp)
    r, d = force.ftp.upload(ref), force.ftp.upload(de)

    def temp_alone():
        out = temp.forward(d)
        vals = torch.stack([out[k].to(torch.float64) for k in
                            ("t_mean", "t_min", "t_max", "valid_pixels")]).cpu().tolist()
        return dict(zip(("t_mean", "t_min", "t_max", "valid_pixels"), vals))

    def gate_force():
        line = hold_force(path, args, ref, de, device, roi_from_finite=True, inputs=models)
        return {"against": "jax_record", **force_gap(path, device_force(force, r, d)),
                "jax": line}

    def check_inputs():
        smoke.check_jax_inputs(path, ref=ref, **{"def": de}, **models)

    def gate_temp():
        check_inputs()
        res = temp.to_host(temp.forward(d))
        line = smoke.hold_temperature_to_jax(
            path, res, stats=temperature_stats(res, tcfg.crop_output_to_outer_roi))
        return {"against": "jax_record", **stats_gaps(path, temp_alone()), "jax": line}

    def gate_call():
        check_inputs()
        seq = mm(ref, de)
        line = smoke.hold_temperature_to_jax(path, seq["temperature"],
                                             stats=seq["temperature_stats"])
        return {"against": "jax_record", **force_gap(path, seq["force"]["force_N"]),
                "jax": line}

    def gate_scalars():
        check_inputs()
        seq, sc = mm(ref, de), mm.step_fused(ref, de, fetch="scalars")
        line = smoke.hold_temperature_to_jax(path, seq["temperature"],
                                             stats=seq["temperature_stats"], scalars=sc)
        return {"against": "jax_record", "scalars": sc, "jax": line}
    return [
        Row(f"{path}_force", "the force alone: forward + volume + force model, frames on the "
            "device, the force fetched", lambda: device_force(force, r, d), gate_force,
            SLOW, fps, routed=(force.ftp,)),
        Row(f"{path}_temp", "the temperature forward alone, the frame on the device, its "
            "scene scalars fetched", temp_alone, gate_temp, FAST, fps, routed=(temp,)),
        Row(f"{path}_call", "MultimodalPipeline.__call__ from numpy frames (one pinned "
            "upload of the deformed frame), every map to the host", lambda: mm(ref, de),
            gate_call, SLOW, fps, routed=(force.ftp, temp)),
        Row(f"{path}_scalars", "MultimodalPipeline.step_fused(fetch='scalars') from numpy "
            "frames, one fetch of the scalars", lambda: mm.step_fused(ref, de, fetch="scalars"),
            gate_scalars, SLOW, fps, routed=(mm,))]


def suite_mm(device) -> List[Row]:
    return (multimodal_rows(device, "mm4k", FTPConfig().deploy(), TempConfig().deploy())
            + multimodal_rows(device, "mm4k_parity", FTPConfig(), TempConfig()))


# ---------------------------------------------------------------------------
# streams, limb, config 2/3
# ---------------------------------------------------------------------------
def batched_force(cfg, device):
    from vistaf_torch.ftp.pipeline import FTPPipeline
    from vistaf_torch.parallel import BatchedForce
    return BatchedForce(FTPPipeline(cfg, smoke.P2H_MODEL, device=device), smoke.FORCE_MODEL)


def streaming(bf):
    from vistaf_torch.pipelines.streaming import StreamingForce
    return StreamingForce(bf, smoke.STREAMS, window=smoke.WINDOW, ema_alpha=smoke.EMA_ALPHA)


def stream_rates(p50_ms: float) -> Dict[str, float]:
    return {"batch_hz": 1000.0 / p50_ms, "stream_frames_per_s": smoke.STREAMS * 1000.0 / p50_ms}


def limb_rates(p50_ms: float) -> Dict[str, Any]:
    hz = 1000.0 / p50_ms
    return {"step_hz": hz, "target_hz": CONFIG5_HZ, "meets_target": hz >= CONFIG5_HZ}


def limb_rows(device) -> List[Row]:
    """Config 5: both whole-limb heads over ``chip_smoke.limb_inputs`` on a
    world-1 stream mesh (NCCL on the card), the total force fetched."""
    from vistaf_torch.parallel import (make_stream_mesh, shard_batch, whole_limb_step,
                                       whole_limb_step_aux)
    import torch.distributed as dist
    cfg, refs, defs, (pose, accel) = smoke.limb_inputs()
    mesh = make_stream_mesh(device=torch.device(device).type)
    CLEANUP.append(dist.destroy_process_group)
    bf = batched_force(cfg, device)
    step = whole_limb_step(bf, mesh, map_stride=smoke.LIMB_STRIDE)
    step_aux = whole_limb_step_aux(bf, mesh, smoke.LIMB_CANVAS, map_stride=smoke.LIMB_STRIDE)
    rs, ds = shard_batch(mesh, refs), shard_batch(mesh, defs)
    aux = {"pose_px": shard_batch(mesh, pose), "accel_mss": shard_batch(mesh, accel)}

    def gate():
        got = {k: v.cpu().numpy() for k, v in step(rs, ds).items()}
        got_aux = {k: v.cpu().numpy() for k, v in step_aux(rs, ds, aux).items()}
        line = smoke.hold_limb_to_jax((refs, defs, (pose, accel)), got, got_aux)
        return {"against": "jax_record", "jax": line}
    return [Row("limb640", "whole_limb_step over 4 streams at 640x480 (BASELINE config 5), "
                "world-1 mesh, the total force fetched",
                lambda: float(step(rs, ds)["total_force_N"]), gate, SLOW, limb_rates,
                routed=(step,)),
            Row("limb640_aux", "whole_limb_step_aux (poses, IMU gates) over the same streams",
                lambda: float(step_aux(rs, ds, aux)["total_force_N"]), gate, SLOW,
                limb_rates, routed=(step_aux,))]


def suite_streams(device) -> List[Row]:
    cfg, refs, seq = smoke.stream_inputs()
    bf = batched_force(cfg, device)
    sf = streaming(bf)
    r, b = torch.as_tensor(refs, device=device), torch.as_tensor(seq[0], device=device)

    def gate():
        fresh = streaming(batched_force(cfg, device))
        line = smoke.hold_streams_to_jax(refs, seq, [fresh(refs, x) for x in seq])
        return {"against": "jax_record", "jax": line}
    rows = [Row("streams640", "StreamingForce, 4 streams at 640x480, window 8 (BASELINE "
                "config 4): one batch on the device, its outputs fetched",
                lambda: sf(r, b), gate, SLOW, stream_rates, routed=(sf,))]
    rows += limb_rows(device)
    rows += temperature_rows(device, TempConfig().deploy(), "temp4k")
    rows += temperature_rows(device, TempConfig(), "temp4k_parity")
    return rows + [force_row("hist640", device)]


def suite_config23(device) -> List[Row]:
    args, ref, de = force_inputs("640")
    pipe = ForcePipeline(*args, device=device)
    r, d = pipe.ftp.upload(ref), pipe.ftp.upload(de)
    c2, c3 = pipe.contact_classification_device(), pipe.force_map_device()

    def direct():
        return pipe(ref, de, roi_from_finite=True)

    def gate2():
        contact, area, _ = c2(r, d)
        want = direct()["contact_area_mm2"]
        gap = smoke.rel_gap(area, want)
        assert gap <= CALL_RTOL, (float(area), want)
        return {"against": "ForcePipeline.__call__", "contact_area_mm2": float(area),
                "contact_area_mm2_call": want, "gap": gap,
                "contact_taxels": int(contact.sum())}

    def gate3():
        fmap, _, force = c3(r, d)
        want = direct()["force_N"]
        gap = smoke.rel_gap(force, want)
        map_gap = smoke.rel_gap(fmap.to(torch.float64).sum(), force)
        assert gap <= CALL_RTOL and map_gap <= CALL_RTOL, (float(force), want, map_gap)
        return {"against": "ForcePipeline.__call__", "force_N": float(force),
                "force_N_call": want, "gap": gap, "map_sum_gap": map_gap}
    return [Row("config2", "ForcePipeline.contact_classification_device at 640x480 deploy "
                "(BASELINE config 2), frames on the device, the contact area fetched",
                lambda: float(c2(r, d)[1]), gate2, FAST, fps, routed=(pipe.ftp,)),
            Row("config3", "ForcePipeline.force_map_device at 640x480 deploy (BASELINE "
                "config 3), frames on the device, the force fetched",
                lambda: float(c3(r, d)[2]), gate3, FAST, fps, routed=(pipe.ftp,))]


# ---------------------------------------------------------------------------
# ingest
# ---------------------------------------------------------------------------
def suite_ingest(device) -> List[Row]:
    import cv2
    from vistaf_torch.pipelines.multimodal import MultimodalPipeline
    from vistaf_torch.runner import native
    from vistaf_torch.runner.io import imread_bgr, iter_images_bgr
    from vistaf_torch.temperature.inference import TemperaturePipeline
    from vistaf_torch.utils.synthetic import synthetic_deploy_temp_weights

    fcfg, tcfg = FTPConfig().deploy(), TempConfig().deploy()
    tmp = tempfile.TemporaryDirectory()
    CLEANUP.append(tmp.cleanup)
    paths = {}
    for name, frame in zip(("ref", "def"), smoke.multimodal_inputs(fcfg, tcfg)):
        paths[name] = os.path.join(tmp.name, f"{name}.jpg")
        assert cv2.imwrite(paths[name], frame)
    ref, de = imread_bgr(paths["ref"]), imread_bgr(paths["def"])
    rows = []

    def gate_decode():
        got = imread_bgr(paths["def"])
        _, want = next(iter_images_bgr([paths["def"]]))
        assert got.shape == (smoke.H4K, smoke.W4K, 3) and np.array_equal(got, want)
        return {"against": "iter_images_bgr", "equal": True, "bytes": got.nbytes,
                "native_decoder": native.native_available()}
    rows.append(Row("decode", "one 2160x3840 JPEG to BGR with cv2 (runner/io.py::imread_bgr)",
                    lambda: imread_bgr(paths["def"]), gate_decode, FAST._replace(profile=0), fps))

    host = torch.from_numpy(de)
    pinned = host.pin_memory() if torch.device(device).type == "cuda" else host

    def upload_rates(p50_ms):
        return {"bytes": host.numel(), "GB_per_s": host.numel() / 1e9 / (p50_ms / 1e3)}

    for name, src, what in (("upload_pageable", host, "from pageable memory"),
                            ("upload_pinned", pinned, "from pinned memory, non_blocking")):
        def up(src=src):
            return src.to(device, non_blocking=True)

        def gate_up(up=up):
            assert torch.equal(up().cpu(), host)
            return {"against": "the host frame", "equal": True}
        rows.append(Row(name, f"one 24 MB 2160x3840 BGR frame to the device {what}", up,
                        gate_up, FAST, upload_rates, group="upload"))

    fp = ForcePipeline(*force_args(fcfg), device=device)
    ref_dev = fp.ftp.upload(ref)

    def camera():
        frame = torch.from_numpy(imread_bgr(paths["def"])).to(device)
        return device_force(fp, ref_dev, frame)

    def gate_camera():
        force, want = camera(), fp(ref, de, roi_from_finite=True)["force_N"]
        gap = smoke.rel_gap(force, want)
        assert gap <= CALL_RTOL, (force, want)
        return {"against": "ForcePipeline.__call__", "force_N": force, "force_N_call": want,
                "gap": gap}
    rows.append(Row("camera_to_force", "decode, upload, the 2160x3840 deploy forward + "
                    "volume + force model, the force fetched; serialized per frame", camera,
                    gate_camera, SLOW, fps, routed=(fp.ftp,)))

    color, wide = synthetic_deploy_temp_weights(smoke.SEED)
    mm = MultimodalPipeline(ForcePipeline(*force_args(fcfg), device=device),
                            TemperaturePipeline(tcfg, color, wide, device=device))
    mm_ref = mm.ingest(ref)

    def two_uploads():
        return {"force": mm.force(mm_ref, de, roi_from_finite=True),
                "temperature": mm.temperature(de)}

    def one_upload():
        return mm(mm_ref, mm.ingest(de))

    def fused():
        return mm.step_fused(mm_ref, de, fetch="scalars")

    def gate_two():
        two, one = two_uploads(), one_upload()
        for part in ("force", "temperature"):
            for k, v in two[part].items():
                np.testing.assert_array_equal(v, one[part][k], err_msg=f"{part}.{k}")
        return {"against": "MultimodalPipeline.__call__ (one upload)", "bit_equal": True}

    def gate_one():
        o = one_upload()
        want = fp(ref, de, roi_from_finite=True)["force_N"]
        assert o["force"]["force_N"] == want, (o["force"]["force_N"], want)
        return {"against": "ForcePipeline.__call__", "force_N": want, "equal": True,
                "valid_pixels": o["temperature_stats"]["valid_pixels"]}

    def gate_fused():
        sc, o = fused(), one_upload()
        fs, ts = o["force"], o["temperature_stats"]
        rel = smoke.MM_SCALAR_REL + smoke.MM_FETCH_REL
        for k in ("volume_cm3", "force_N", "contact_area_mm2"):
            assert abs(sc[k] - fs[k]) <= rel * abs(fs[k]) + 1e-7, (k, sc[k], fs[k])
        for k in ("mean", "min", "max"):
            assert abs(sc[f"t_{k}_C"] - ts[f"{k}_C"]) <= smoke.MM_STATS_ATOL, (k, sc, ts)
        assert sc["valid_pixels"] == ts["valid_pixels"], (sc, ts)
        return {"against": "MultimodalPipeline.__call__ (one upload)", "scalars": sc}
    both = (mm.force.ftp, mm.temperature)
    for name, fn, gate, what, routed in (
            ("mm_2_uploads", two_uploads, gate_two, "ForcePipeline and TemperaturePipeline "
             "each given the numpy frame: two pageable uploads", both),
            ("mm_ingest_1_upload", one_upload, gate_one, "MultimodalPipeline.__call__ given "
             "ingest's one pinned upload", both),
            ("mm_fused_scalars_1_upload", fused, gate_fused, "MultimodalPipeline.step_fused("
             "fetch='scalars') from the numpy frame: one pinned upload", (mm,))):
        rows.append(Row(name, f"2160x3840 multimodal deploy, the reference on the device: "
                        f"{what}", fn, gate, SLOW, fps, group="mm_ingest", routed=routed))

    cfg, refs, seq = smoke.stream_inputs()
    bf_serial, bf_over = batched_force(cfg, device), batched_force(cfg, device)
    sf_serial, sf_over = streaming(bf_serial), streaming(bf_over)

    def gate_streams():
        over = streaming(batched_force(cfg, device)).run_overlapped(refs, seq)
        fresh = streaming(batched_force(cfg, device))
        for o, s in zip(over, [fresh(refs, b) for b in seq]):
            for k in o:
                np.testing.assert_array_equal(o[k], s[k], err_msg=k)
        line = smoke.hold_streams_to_jax(refs, seq, over)
        return {"against": "jax_record and the serialized batches", "bit_equal": True,
                "jax": line}

    def seq_rates(p50_ms):
        n = len(seq)
        return {"batches": n, "ms_per_batch": p50_ms / n,
                "stream_frames_per_s": smoke.STREAMS * n * 1000.0 / p50_ms,
                "batch_bytes": int(seq[0].nbytes)}
    rows.append(Row("streams_serialized", "six streams640 batches from numpy, each uploaded, "
                    "stepped and fetched in turn", lambda: [sf_serial(refs, b) for b in seq],
                    gate_streams, SEQUENCE, seq_rates, group="streams_ingest",
                    routed=(sf_serial,)))
    rows.append(Row("streams_overlapped", "the same six batches through "
                    "StreamingForce.run_overlapped (pinned double-buffered uploads)",
                    lambda: sf_over.run_overlapped(refs, seq), gate_streams, SEQUENCE,
                    seq_rates, group="streams_ingest", routed=(sf_over,)))
    return rows


SUITE_ROWS = {"default": suite_default, "4k": suite_4k, "mm": suite_mm,
              "streams": suite_streams, "config23": suite_config23, "ingest": suite_ingest}


# ---------------------------------------------------------------------------
# timing and the rows' lines
# ---------------------------------------------------------------------------
def call_times(fn, calls: int, cuda: bool) -> List[float]:
    """Milliseconds of each of ``calls`` calls: CUDA events on the card,
    the host's clock on the CPU."""
    if cuda:
        return profiling.event_times(fn, calls)
    times = []
    for _ in range(calls):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def time_in_turns(fns: List[Callable], rounds: int, iters: int, cuda: bool):
    """Each function's rounds of ``iters`` timed calls, the functions taking
    turns round by round (reversed every other round)."""
    out = [[] for _ in fns]
    for r in range(rounds):
        order = range(len(fns)) if r % 2 == 0 else reversed(range(len(fns)))
        for i in order:
            out[i].append(call_times(fns[i], iters, cuda))
    return out


def run_gate(row: Row) -> Dict[str, Any]:
    """The row's gate, with ``chip_smoke``'s own lines sent to standard
    error: (correct, what it compared or why it failed)."""
    try:
        with contextlib.redirect_stdout(sys.stderr):
            return {"correct": True, "gate": row.gate()}
    except Exception as e:     # an AssertionError is a failed gate, anything else a fault
        return {"correct": False, "gate": {"failed": repr(e)[:2000]}}


def observe(row: Row) -> Dict[str, Any]:
    """Apart from the timing: one call's host syncs and hand-written
    kernel launches, then the profiled window."""
    before = dict(kernels.LAUNCHES)
    syncs = profiling.host_syncs(row.fn)
    torch.cuda.synchronize()
    launches = {k: v - before[k] for k, v in kernels.LAUNCHES.items() if v != before[k]}
    return {"host_syncs_per_call": syncs, "kernel_launches_per_call": launches,
            "profile": profiling.profile_window(row.fn, row.timing.profile, copies=True)}


def run_rows(suite: str, rows: List[Row], device, card: Optional[str],
             rounds: Optional[int] = None, iters: Optional[int] = None,
             warmup: Optional[int] = None) -> List[Dict[str, Any]]:
    """Gate, warm up, time (a group's rows in turns) and observe each row;
    returns the rows' lines in order.  ``rounds``, ``iters`` and ``warmup``
    override every row's own.  A row whose function raises is a failed row
    with the error beside it; the others still run."""
    cuda = torch.device(device).type == "cuda"
    lines = {}
    groups: Dict[str, List[Row]] = {}
    for row in rows:
        groups.setdefault(row.group or row.name, []).append(row)
    for members in groups.values():
        R, N, W, _ = members[0].timing
        R, N, W = rounds or R, iters or N, warmup or W
        try:
            for row in members:
                lines[row.name] = {"row": row.name, "suite": suite, "what": row.what,
                                   "device": str(device), **forward_route(row.routed),
                                   **run_gate(row)}
                for _ in range(W - 1):
                    row.fn()
            timed = time_in_turns([m.fn for m in members], R, N, cuda)
            for row, samples in zip(members, timed):
                line = lines[row.name]
                stats = profiling.round_stats(samples)
                line.update(clock="cuda_events" if cuda else "host", rounds=R,
                            iters_per_round=N, warmup=W, **stats,
                            **(row.rates(stats["p50_ms"]) if row.rates else {}))
                if not cuda:
                    line.update(host_syncs_per_call="not measured", profile="not measured")
                elif row.timing.profile:
                    line.update(observe(row))
                else:
                    line.update(host_syncs_per_call="host only", profile="host only")
        except Exception as e:
            for row in members:
                lines.setdefault(row.name, {"row": row.name, "suite": suite, "what": row.what,
                                            "device": str(device)})
                lines[row.name].update(correct=False, error=repr(e)[:2000])
        for row in members:
            line = lines[row.name]
            line.update(card=card, correct=line.pop("correct"), gate=line.pop("gate", None))
    return [lines[row.name] for row in rows]


def bench_line(line: Dict[str, Any]) -> Dict[str, Any]:
    """The ``640`` row with ``bench.py``'s keys: metric, value (frames/s =
    1000 / p50), unit, vs_baseline (over BASELINE_FPS) and its stats."""
    p50 = line["p50_ms"]
    per = "card" if line["clock"] == "cuda_events" else "cpu"
    value = 1000.0 / p50
    out = {"metric": f"frames/sec/{per} at 640x480 frame->force; p50 latency {p50:.2f} ms",
           "value": value, "unit": f"frames/sec/{per}", "vs_baseline": value / BASELINE_FPS,
           "reps": line["rounds"], "iters_per_rep": line["iters_per_round"]}
    if line["tail"] == "p90":
        out["p90_ms"] = line["tail_ms"]
    return {**out, **line}


def run_suite(suite: str, device, card: Optional[str] = None,
              only: Optional[Sequence[str]] = None, **overrides):
    """One suite's lines (``default``: its ``640`` line last, with
    ``bench.py``'s keys), of the rows named in ``only`` if given, then the
    suite's ``CLEANUP``."""
    try:
        rows = SUITE_ROWS[suite](device)
        if only:
            unknown = set(only) - {r.name for r in rows}
            if unknown:
                raise ValueError(f"no rows {sorted(unknown)} in the {suite} suite")
            rows = [r for r in rows if r.name in only]
        lines = run_rows(suite, rows, device, card, **overrides)
    finally:
        while CLEANUP:
            CLEANUP.pop()()
    if suite == "default" and lines[0]["row"] == "640":
        lines.append(bench_line(lines.pop(0)))
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("suite", nargs="?", default="default", choices=SUITES + ("all",))
    ap.add_argument("--out", help="also write the rows to this JSON file")
    ap.add_argument("--rounds", type=int, help="rounds of every row (default: the row's)")
    ap.add_argument("--iters", type=int, help="timed calls a round (default: the row's)")
    ap.add_argument("--rows", nargs="+", help="only these rows of the suite")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_torch: CUDA is not available; the bench times the card and has no CPU "
              "fallback", file=sys.stderr)
        return 1
    from vistaf_torch import use_full_fp32
    card = smoke.card_line()
    use_full_fp32()
    t0 = time.perf_counter()
    kernels.library()
    print(dumps({"card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
                 "build_s": time.perf_counter() - t0}), file=sys.stderr, flush=True)
    device = torch.device("cuda", 0)
    rows, clock = [], {}
    for suite in SUITES if args.suite == "all" else (args.suite,):
        t1 = time.perf_counter()
        for line in run_suite(suite, device, card, only=args.rows, rounds=args.rounds,
                              iters=args.iters):
            rows.append(line)
            print(dumps(line), flush=True)
        torch.cuda.empty_cache()
        clock[suite] = time.perf_counter() - t1
    print(dumps({"clock_s": clock, "total_s": time.perf_counter() - t0}), file=sys.stderr)
    if args.out:
        with open(args.out, "w") as f:
            f.write(dumps(rows))
    failed = [r["row"] for r in rows if not r["correct"]]
    if failed:
        print(f"bench_torch: rows failing their gates: {failed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
