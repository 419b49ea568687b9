"""The whole-limb heads across several cards, one process per card.

    python3 chip_limb_ranks.py [--ranks 4] [--device cuda|cpu]

BASELINE config 5 as a deployment runs it: the parent starts ``--ranks``
processes of this script with torchrun's environment (``MASTER_ADDR``,
``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``); each brings the
group up through ``initialize_multihost`` (NCCL on its card
``cuda:LOCAL_RANK``; gloo only with ``--device cpu``), takes its block of
``chip_smoke.py``'s four 640x480 deploy streams with ``shard_batch`` and runs
``whole_limb_step`` and ``whole_limb_step_aux`` over the mesh, whose gathers
and reductions cross the cards: three times each, the first call eager (on
a card it then captures the step's CUDA graph, the NCCL all-reduces
inside), the second a replay that must equal it bit for bit but for the
sums over the ranks (within 1e-6: NCCL may order a captured sum
otherwise), the third the one kept.  On a card each step (a rank's streams
in one batched forward) must launch
exactly what a ``limb640`` step launches, and
each rank prints its ``timing`` lines (the fusion alone too, now over the
interconnect), every step a replay.  When
the ranks are done the parent runs the same heads at world 1 in its own
process and holds every rank to it: per-stream forces, maps, gates and the
canvas equal, the sums within 1e-6 relative, and every rank's replicated
outputs the same.  Each rank's lines, then a summary line and, last,
``{"ok": true, ...}``; exits non-zero if any of it fails or a rank does not
end within ``--timeout`` seconds (the first rank to fail stops the others,
and every rank's log is printed).
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np

import chip_smoke as cs

KEYS = ("per_stream_force", "total_force_N", "max_depth_mm", "contact_area_mm2",
        "whole_limb_map_mm")
AUX_KEYS = ("per_stream_force", "stream_gate", "total_force_N", "max_depth_mm",
            "contact_area_mm2", "limb_canvas_mm")
SUMS = ("total_force_N", "contact_area_mm2")


def heads(device, card, rank_label=None):
    """Both heads over this process's block of the streams, on the mesh of
    the group that is up (or a world-1 group): their outputs as numpy, and
    this rank's launches a stream frame."""
    import torch
    from vistaf_torch import kernels
    from vistaf_torch.ftp.pipeline import FTPPipeline
    from vistaf_torch.parallel import (BatchedForce, make_stream_mesh, shard_batch,
                                       whole_limb_step, whole_limb_step_aux)
    from vistaf_torch.parallel.mesh import mesh_device

    cfg, refs, defs, (pose, accel) = cs.limb_inputs()
    mesh = make_stream_mesh(device=device.type)
    dev = mesh_device(mesh)
    bf = BatchedForce(FTPPipeline(cfg, cs.P2H_MODEL, device=dev), cs.FORCE_MODEL)
    rs, ds = shard_batch(mesh, refs), shard_batch(mesh, defs)
    aux = {"pose_px": shard_batch(mesh, pose), "accel_mss": shard_batch(mesh, accel)}
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    step = whole_limb_step(bf, mesh, map_stride=cs.LIMB_STRIDE)
    step_aux = whole_limb_step_aux(bf, mesh, cs.LIMB_CANVAS, map_stride=cs.LIMB_STRIDE)
    sync()
    kernels.reset_launches()
    # the first call of each step runs eagerly (and, on a card, captures its
    # CUDA graph); the second replays it and must give the same bits, but
    # for the sums over the ranks, whose order NCCL may choose otherwise for
    # a captured all-reduce (within 1e-6, as against the world-1 run)
    first, first_aux = step(rs, ds), step_aux(rs, ds, aux)
    sync()
    cs.say("limb_rank_progress", rank=rank_label, done="eager calls and captures")
    out, out_aux = step(rs, ds), step_aux(rs, ds, aux)
    sync()
    cs.say("limb_rank_progress", rank=rank_label, done="replays")
    for name, got, want in (("limb", out, first), ("limb_aux", out_aux, first_aux)):
        for k in SUMS:
            a, b = float(got.pop(k)), float(want.pop(k))
            assert abs(a - b) <= 1e-6 * abs(b), (name, k, a, b)
        cs.same_outputs(name, got, want)
    out, out_aux = step(rs, ds), step_aux(rs, ds, aux)
    per_step = {k: v / 6 for k, v in kernels.LAUNCHES.items()}
    if dev.type == "cuda":
        assert step.graph is not None and step_aux.graph is not None
        want = {k: float(cs.PATH_EXACT_LAUNCHES["limb640"].get(k, 0)) for k in per_step}
        assert per_step == want, (per_step, want)
        cs.time_limb("limb_ranks", bf, mesh, rs, ds, aux, card, step, step_aux,
                     rank=rank_label, world=mesh.size())
    res = {f"plain_{k}": out[k].cpu().numpy() for k in KEYS}
    res.update({f"aux_{k}": out_aux[k].cpu().numpy() for k in AUX_KEYS})
    return res, per_step, mesh.size()


def threads(ranks: int) -> int:
    """PyTorch threads a process: the cores split over the ranks (the
    parent's world-1 run takes as many, since on the CPU a reduction's
    order, and so its bits, follows the thread count)."""
    return max(1, (os.cpu_count() or 1) // ranks)


def rank_main(out_path, device, card):
    import torch
    import torch.distributed as dist
    from vistaf_torch.parallel import global_stream_count, initialize_multihost
    torch.set_num_threads(threads(int(os.environ["WORLD_SIZE"])))
    assert initialize_multihost(device=device.type) is True
    try:
        res, per_step, world = heads(device, card, rank_label=dist.get_rank())
        assert world == global_stream_count() == int(os.environ["WORLD_SIZE"])
        np.savez(out_path, rank=dist.get_rank(), world=world, **res)
        cs.say("limb_rank", rank=dist.get_rank(), world=world, backend=dist.get_backend(),
               device=str(torch.device(device.type, torch.cuda.current_device())
                          if device.type == "cuda" else device),
               launches_per_step=per_step,
               per_stream_force=res["plain_per_stream_force"].tolist(),
               total_force_N=float(res["plain_total_force_N"]))
    finally:
        # the steps' graphs hold the group's NCCL all-reduces: they go first
        gc.collect()
        dist.destroy_process_group()
        cs.say("limb_rank_progress", rank=int(os.environ["RANK"]), done="group destroyed")


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--timeout", type=float, default=600.0)
    ap.add_argument("--rank-out", help=argparse.SUPPRESS)
    args = ap.parse_args()
    import torch
    if args.device == "cuda" and not torch.cuda.is_available():
        print("chip_limb_ranks: CUDA is not available", file=sys.stderr)
        return 1
    device = torch.device(args.device)
    card = cs.card_line() if args.device == "cuda" else "cpu"
    if args.rank_out:
        if args.device == "cuda":
            from vistaf_torch import use_full_fp32
            use_full_fp32()
        rank_main(args.rank_out, device, card)
        return 0
    if cs.STREAMS % args.ranks:
        raise SystemExit(f"--ranks must divide the {cs.STREAMS} streams")
    if args.device == "cuda":
        assert torch.cuda.device_count() >= args.ranks, torch.cuda.device_count()
        from vistaf_torch import kernels, use_full_fp32
        use_full_fp32()
        kernels.build()                  # once, before the ranks load it
    cs.say("device", card=card, ranks=args.ranks, cards=torch.cuda.device_count())

    port = free_port()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        outs = [os.path.join(tmp, f"rank{r}.npz") for r in range(args.ranks)]
        env = {k: v for k, v in os.environ.items()
               if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")}
        logs = [tempfile.TemporaryFile(dir=tmp) for _ in range(args.ranks)]
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--device", args.device,
             "--rank-out", outs[r]],
            env={**env, "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
                 "WORLD_SIZE": str(args.ranks), "RANK": str(r), "LOCAL_RANK": str(r)},
            stdout=log, stderr=subprocess.STDOUT)
            for r, log in enumerate(logs)]
        # a rank that fails leaves the others waiting in a collective: stop
        # them all at the first failure, or at the timeout
        try:
            while any(p.poll() is None for p in procs):
                if any(p.poll() not in (None, 0) for p in procs) or (
                        time.perf_counter() - t0 > args.timeout):
                    break
                time.sleep(0.5)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
            for log in logs:
                log.seek(0)
                text = log.read().decode(errors="replace")
                print(text, end="" if text.endswith("\n") else "\n", flush=True)
                log.close()
        for r, p in enumerate(procs):
            assert p.returncode == 0, f"rank {r} exited {p.returncode}"
        ranks = [dict(np.load(o)) for o in outs]
    ranks_s = time.perf_counter() - t0

    torch.set_num_threads(threads(args.ranks))
    one, _, world = heads(device, card)            # world 1, this process
    import torch.distributed as dist
    gc.collect()
    dist.destroy_process_group()
    assert world == 1
    gaps = {}
    for r, res in enumerate(ranks):
        assert int(res["rank"]) == r and int(res["world"]) == args.ranks
        for k, v in one.items():
            got = res[k]
            assert got.shape == v.shape and got.dtype == v.dtype == np.float32, (r, k)
            if k.split("_", 1)[1] in SUMS:
                gaps[k] = max(gaps.get(k, 0.0), float(abs(got - v) / abs(v)))
                assert abs(got - v) <= 1e-6 * abs(v), (r, k, got, v)
            else:
                np.testing.assert_array_equal(got, v, err_msg=f"rank {r} {k}")
            np.testing.assert_array_equal(got, ranks[0][k], err_msg=f"rank {r} {k}")
    _, _, _, (pose, _) = cs.limb_inputs()
    np.testing.assert_array_equal(
        one["aux_limb_canvas_mm"],
        cs.max_blend(one["plain_whole_limb_map_mm"], one["aux_stream_gate"], pose,
                     cs.LIMB_CANVAS, cs.LIMB_STRIDE))
    cs.say("limb_ranks", ranks=args.ranks, device=args.device, card=card,
           per_stream_force=one["plain_per_stream_force"].tolist(),
           stream_gate=one["aux_stream_gate"].tolist(),
           sums_rel_gap_vs_world1=gaps, ranks_seconds=ranks_s)
    print(json.dumps({"ok": True, "ranks": args.ranks, "device": args.device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
