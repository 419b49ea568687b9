"""Where a stream batch's time goes on one GPU: the ``streams640`` batch
(``chip_smoke.stream_inputs``: 4 streams of 640x480 under the deploy preset)
through ``StreamingForce`` and the aux whole-limb step on a world-1 NCCL mesh.

    python3 scripts/torch_stream_breakdown.py

Run it from the root of a tree of the repository.  Every ``*_ms`` is the
median of 10 calls, each between two CUDA events after a
``torch.cuda.synchronize`` (``profiling.event_times``); every ``*_host_ms``
the median of 7 calls' time to return on the host, synchronized before.
It prints one JSON line:

- ``step_ms``, ``call_ms``, ``call_numpy_ms``: ``StreamingForce._step`` on
  device stacks (one replay of the step's graph), ``__call__`` on them (the
  outputs fetched) and ``__call__`` from numpy frames (uploaded first);
  ``to_host_ms`` the fetch alone and ``upload_numpy_ms`` the uploads alone;
- ``replay_ms`` / ``replay_host_ms``: the step's ``CUDAGraph.replay()``
  alone; ``single_replay_ms`` / ``single_replay_host_ms`` one stream's
  forward graph (``FTPPipeline.forward``) alone;
- ``per_stream_ms`` / ``per_stream_host_ms``: the batch as it ran before
  one graph held it: each stream through the forward's own graph, the
  volume -> force tail op by op, the stack and ``update``;
- ``device_ops_batch`` / ``device_ops_frame`` / ``device_ops_per_stream``:
  device operations (kernels, copies, fills) one replay of the step's
  graph / of one stream's forward graph / the per-stream batch above runs,
  from ``torch.profiler``;
- ``after_profiler_*``: the step's, one stream's and the aux step's replay
  timed again once that profiler has run in the process;
- ``aux_step_ms``, ``aux_step_host_ms``, ``aux_replay_ms``,
  ``aux_replay_host_ms``: the same for ``whole_limb_step_aux``;
- ``card``: the card's name and power limit.
"""
import json
import os
import sys
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.getcwd())
import chip_smoke as cs  # noqa: E402
from vistaf_torch import kernels, use_full_fp32  # noqa: E402
from vistaf_torch.ftp.pipeline import FTPPipeline  # noqa: E402
from vistaf_torch.parallel import (BatchedForce, make_stream_mesh, shard_batch,  # noqa: E402
                                   whole_limb_step_aux)
from vistaf_torch.pipelines import streaming  # noqa: E402
from vistaf_torch.utils import cuda_graph  # noqa: E402
from vistaf_torch.utils.profiling import event_times  # noqa: E402


def ms(fn) -> float:
    return float(np.median(event_times(fn, 10, warmup=2)))


def host_ms(fn) -> float:
    times = []
    for _ in range(7):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return float(np.median(times))


def device_ops(fn, reps: int = 2) -> float:
    fn()
    torch.cuda.synchronize()
    cuda_graph.note_profiler()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages() if e.device_type == DeviceType.CUDA) / reps


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_stream_breakdown: CUDA is not available", file=sys.stderr)
        return 1
    use_full_fp32()
    kernels.library()
    dev = torch.device("cuda", 0)
    cfg, refs, seq = cs.stream_inputs()
    r, b = torch.as_tensor(refs, device=dev), torch.as_tensor(seq[0], device=dev)
    bf = BatchedForce(FTPPipeline(cfg, cs.P2H_MODEL, device=dev), cs.FORCE_MODEL)
    sf = streaming.StreamingForce(bf, cs.STREAMS, window=cs.WINDOW, ema_alpha=cs.EMA_ALPHA)
    sf._step(r, b)                                  # eager, then the capture
    graph = sf._graph.graph
    out = {"step_ms": ms(lambda: sf._step(r, b)), "call_ms": ms(lambda: sf(r, b)),
           "call_numpy_ms": ms(lambda: sf(refs, seq[0]))}
    fetched = sf._step(r, b)
    out["to_host_ms"] = ms(lambda: streaming._to_host([fetched]))
    out["upload_numpy_ms"] = ms(lambda: (sf._upload(refs), sf._upload(seq[0])))
    out["replay_ms"], out["replay_host_ms"] = ms(graph.replay), host_ms(graph.replay)

    def per_stream():
        res = [bf._single(r[s], b[s]) for s in range(r.shape[0])]
        stacked = {k: torch.stack([x[k] for x in res]) for k in res[0]}
        streaming.update(streaming.init_state(cs.STREAMS, cs.WINDOW, dev), stacked["force_N"])
    bf.pipe.forward(r[0], b[0])                     # the single forward's capture
    single = bf.pipe._graph.graph
    out.update(per_stream_ms=ms(per_stream), per_stream_host_ms=host_ms(per_stream),
               single_replay_ms=ms(single.replay), single_replay_host_ms=host_ms(single.replay))

    mesh = make_stream_mesh()
    _, lrefs, ldefs, (pose, accel) = cs.limb_inputs()
    rs, ds = shard_batch(mesh, lrefs), shard_batch(mesh, ldefs)
    aux = {"pose_px": shard_batch(mesh, pose), "accel_mss": shard_batch(mesh, accel)}
    step = whole_limb_step_aux(bf, mesh, cs.LIMB_CANVAS, map_stride=cs.LIMB_STRIDE)
    step(rs, ds, aux)
    out.update(aux_step_ms=ms(lambda: step(rs, ds, aux)),
               aux_step_host_ms=host_ms(lambda: step(rs, ds, aux)),
               aux_replay_ms=ms(step.graph.graph.replay),
               aux_replay_host_ms=host_ms(step.graph.graph.replay))
    out.update(device_ops_batch=device_ops(graph.replay),
               device_ops_frame=device_ops(single.replay),
               device_ops_per_stream=device_ops(per_stream))
    # the same replays once torch.profiler has traced the card in the process
    out.update(after_profiler_replay_ms=ms(graph.replay),
               after_profiler_replay_host_ms=host_ms(graph.replay),
               after_profiler_single_replay_host_ms=host_ms(single.replay),
               after_profiler_aux_replay_host_ms=host_ms(step.graph.graph.replay),
               card=cs.card_line())
    print(json.dumps(out), flush=True)
    del step
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
