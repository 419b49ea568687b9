"""One rank of a 2-process ``torch.distributed`` bring-up of the port's
stream mesh on the CPU (gloo), and the cheap per-stream force both the
rank and ``test_torch_parallel.py`` run the whole-limb head over.

Spawned by ``tests/test_torch_multihost.py`` (one instance per rank): joins
a loopback coordinator through ``initialize_multihost(..., device="cpu")``,
builds the stream mesh over both processes, takes this rank's two of the
four seeded streams with ``shard_batch`` and runs one ``whole_limb_step``
(map stride 2), whose gathers and reductions cross the process boundary.
Writes the rank's result as JSON (the per-stream forces and the limb map in
full, so the test can hold them to a world-1 run bit for bit).

Usage: python tests/torch_multihost_worker.py <coord> <rank> <world> <out.json>
"""
import json
import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

H, W, STREAMS = 144, 192, 4


class CheapForce:
    """The torch twin of ``tests/multihost_worker.py::_CheapForce``: a small
    per-stream compute with ``BatchedForce``'s output contract, so the
    fusion head, collectives included, is what a test exercises."""

    depth_eps_mm = 0.01
    device = torch.device("cpu")

    def _single(self, ref_bgr, def_bgr):
        ref, de = torch.as_tensor(ref_bgr), torch.as_tensor(def_bgr)
        diff = de.to(torch.float32) - ref.to(torch.float32)
        # pseudo heightmap [mm]: mean / 100 as XLA compiles it, the channel
        # sum times float32(1 / 300)
        hm = torch.sum(diff, dim=-1) * np.float32(1.0 / 300.0)
        pos = torch.clamp(hm, min=0.0)
        v = torch.sum(pos) * 1e-4
        return {
            "force_N": 2.0 * v,
            "volume_cm3": v,
            "contact_area_mm2": torch.sum(pos > self.depth_eps_mm).to(torch.float32),
            "max_depth_mm": torch.max(pos),
            "height_map_mm": hm,
        }

    def batched(self):
        def fn(refs, frames):
            outs = [self._single(r, f) for r, f in zip(refs, frames)]
            return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}
        return fn


def cheap_streams(n: int, h: int = H, w: int = W, seed: int = 0):
    """``n`` distinct seeded (ref, def) uint8 stream stacks for the cheap
    force: a noisy reference, and a frame carrying a raised disc (its own
    centre, radius and height per stream) over the same noise."""
    rng = np.random.default_rng(seed)
    refs = rng.integers(40, 200, size=(n, h, w, 3)).astype(np.uint8)
    yy, xx = np.mgrid[0:h, 0:w]
    defs = refs.astype(np.int32)
    for k in range(n):
        cy, cx = rng.integers(h // 4, 3 * h // 4), rng.integers(w // 4, 3 * w // 4)
        r = rng.integers(h // 8, h // 3)
        bump = np.clip(1.0 - ((yy - cy) ** 2 + (xx - cx) ** 2) / r ** 2, 0.0, None)
        defs[k] += np.round(rng.uniform(5, 50) * bump).astype(np.int32)[..., None]
        defs[k] += rng.integers(-2, 3, size=(h, w, 3))
    return refs, np.clip(defs, 0, 255).astype(np.uint8)


def main():
    coord, rank, world, out_path = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    torch.set_num_threads(1)
    import torch.distributed as dist
    from vistaf_torch.parallel import (global_stream_count, initialize_multihost,
                                       make_stream_mesh, shard_batch, whole_limb_step)

    assert initialize_multihost(coord, world, rank, device="cpu") is True
    assert initialize_multihost(coord, world, rank, device="cpu") is True   # idempotent
    try:
        mesh = make_stream_mesh(device="cpu")           # spans both processes
        refs, defs = cheap_streams(STREAMS)
        ref_b, def_b = shard_batch(mesh, refs), shard_batch(mesh, defs)
        assert ref_b.shape[0] == STREAMS // world
        try:
            shard_batch(mesh, refs[:STREAMS - 1])
            raise AssertionError("3 streams were split over 2 ranks")
        except ValueError:
            pass
        out = whole_limb_step(CheapForce(), mesh, map_stride=2)(ref_b, def_b)
        limb = out["whole_limb_map_mm"].numpy()
        result = {
            "rank": dist.get_rank(),
            "world": dist.get_world_size(),
            "global_streams": global_stream_count(),
            "local_streams": int(ref_b.shape[0]),
            "total_force_N": float(out["total_force_N"]),
            "max_depth_mm": float(out["max_depth_mm"]),
            "contact_area_mm2": float(out["contact_area_mm2"]),
            "per_stream_force": out["per_stream_force"].numpy().tolist(),
            "limb_map": limb.tolist(),
            "limb_map_shape": list(limb.shape),
        }
    finally:
        dist.destroy_process_group()
    with open(out_path, "w") as f:
        json.dump(result, f)
    print(f"rank {rank} OK total={result['total_force_N']:.6f}", flush=True)


if __name__ == "__main__":
    main()
