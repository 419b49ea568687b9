"""A 2-process ``torch.distributed`` bring-up of the port's stream mesh on
the CPU (gloo): ``tests/torch_multihost_worker.py`` runs each rank, which
joins a loopback coordinator through ``initialize_multihost``, holds two of
four seeded cheap-force streams and runs one ``whole_limb_step`` (map stride
2) whose gathers and reductions cross the process boundary.  What the JAX
package's ``test_multihost_bringup_and_fusion`` asserts, and the world-1
run of the same four streams in this process: per-stream forces, the limb
map and the depth maximum equal, the sums within 1e-6 relative."""
import json
import os
import socket
import subprocess
import sys

import numpy as np
import torch.distributed as dist

from vistaf_torch.parallel import make_stream_mesh, whole_limb_step

from torch_multihost_worker import STREAMS, CheapForce, cheap_streams
from torch_threads import single_torch_thread  # noqa: F401  (autouse)

TIMEOUT_S = 120


def _world_one():
    assert not dist.is_initialized()
    mesh = make_stream_mesh(device="cpu")
    try:
        refs, defs = cheap_streams(STREAMS)
        out = whole_limb_step(CheapForce(), mesh, map_stride=2)(refs, defs)
        return {k: v.numpy() for k, v in out.items()}
    finally:
        dist.destroy_process_group()


def test_two_rank_whole_limb_step(tmp_path):
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")}
    outs = [str(tmp_path / f"rank{i}.json") for i in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(repo, "tests", "torch_multihost_worker.py"),
         f"127.0.0.1:{port}", str(i), "2", outs[i]],
        cwd=repo, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for i in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT_S)[0].decode(errors="replace"))
    finally:
        for p in procs:
            p.kill()
            p.wait()
    for i, p in enumerate(procs):
        assert p.returncode == 0, f"rank {i} failed:\n{logs[i][-3000:]}"
    results = []
    for path in outs:
        with open(path) as f:
            results.append(json.load(f))

    one = _world_one()
    for i, r in enumerate(results):
        assert r["rank"] == i and r["world"] == 2
        assert r["global_streams"] == 2 and r["local_streams"] == 2
        forces = np.asarray(r["per_stream_force"], np.float32)
        limb = np.asarray(r["limb_map"], np.float32)
        assert len(forces) == STREAMS and r["limb_map_shape"][0] == STREAMS
        assert limb.max() > 0.01
        assert abs(forces.sum() - r["total_force_N"]) <= 1e-6 * abs(r["total_force_N"])
        # the world-1 run of the same streams
        np.testing.assert_array_equal(forces, one["per_stream_force"])
        np.testing.assert_array_equal(limb, one["whole_limb_map_mm"])
        assert r["max_depth_mm"] == float(one["max_depth_mm"])
        for k in ("total_force_N", "contact_area_mm2"):
            assert abs(r[k] - float(one[k])) <= 1e-6 * abs(float(one[k])), k
    # the replicated outputs agree on both ranks
    for k in ("total_force_N", "max_depth_mm", "contact_area_mm2", "per_stream_force",
              "limb_map"):
        assert results[0][k] == results[1][k], k
