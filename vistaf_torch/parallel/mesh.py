"""The stream mesh, the batched force forward and the whole-limb heads (JAX
``parallel/mesh.py``).

The JAX package places a stream batch over a ``Mesh`` of devices in one
program and fuses the per-stream results in a ``shard_map`` with
psum/pmax.  The port runs one process per card: the mesh is a 1-D
``"stream"`` ``DeviceMesh`` over the default process group
(``parallel/distributed.py``), each rank runs its own contiguous block of
streams through the force forward on its card, and the fusion heads are the
same reductions as ``torch.distributed`` collectives over the mesh's group
(NCCL on the cards, gloo on the CPU).  Gathers are sums of placed blocks
(each rank writes its streams into a zero (B, ...) tensor), as in JAX: a
sum with zeros is exact, so every rank receives the same bits.

The forward ends its data-dependent loops on host checks, one frame at a
time, so a rank's streams run one after the other on its card; each stream's
result is bit for bit the single forward's.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from vistaf_torch.calib import scalar_models
from vistaf_torch.ftp.pipeline import FTPPipeline
from vistaf_torch.parallel.distributed import backend_for
from vistaf_torch.pipelines.force import depth_map_to_volume_cm3


def make_stream_mesh(n_devices: Optional[int] = None, device: str = "cuda") -> DeviceMesh:
    """The 1-D ``"stream"`` mesh over the default process group, one card
    (or, with ``device="cpu"``, one CPU process) per rank.

    Without a group a world-size-1 group of this process is brought up on
    an in-process store: NCCL on the current card, gloo with
    ``device="cpu"``.  A CPU mesh in a process whose group is NCCL gets a
    gloo group over the same ranks (every rank must ask for it).
    ``n_devices`` other than the world size raises."""
    want = backend_for(device)
    if not dist.is_initialized():
        kw = {"device_id": torch.device("cuda", torch.cuda.current_device())
              } if want == "nccl" else {}
        dist.init_process_group(want, store=dist.HashStore(), rank=0, world_size=1, **kw)
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"a stream mesh of {n_devices} needs {n_devices} processes, "
                         f"the group has {world}")
    backend = dist.get_backend()
    if want == "nccl":
        if backend != "nccl":
            raise RuntimeError(f"the card's stream mesh needs an NCCL group, not {backend!r}")
        return init_device_mesh("cuda", (world,), mesh_dim_names=("stream",))
    if backend == "gloo":
        return init_device_mesh("cpu", (world,), mesh_dim_names=("stream",))
    return DeviceMesh.from_group(dist.new_group(backend="gloo"), "cpu",
                                 mesh_dim_names=("stream",))


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """This rank's device: its current card, or the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _on(mesh: DeviceMesh, x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(mesh_device(mesh))
    return torch.as_tensor(np.ascontiguousarray(x), device=mesh_device(mesh))


def shard_batch(mesh: DeviceMesh, x) -> torch.Tensor:
    """This rank's block of the global (B, ...) batch: streams
    [rank * B / world, (rank + 1) * B / world) on its device.  B must be a
    multiple of the world size."""
    world, rank = mesh.size(), mesh.get_local_rank()
    b = x.shape[0]
    if b % world:
        raise ValueError(f"{b} streams do not split over {world} ranks")
    n = b // world
    return _on(mesh, x[rank * n:(rank + 1) * n])


def shard_local_batch(mesh: DeviceMesh, local_x) -> torch.Tensor:
    """This rank's own streams (leading axis) on its device."""
    return _on(mesh, local_x)


def gather_streams(mesh: DeviceMesh, local: torch.Tensor) -> torch.Tensor:
    """Every rank's (n, ...) block in rank order, (n * world, ...) on every
    rank: the all-reduce sum of this rank's block placed in zeros (exact)."""
    n = local.shape[0]
    rank = mesh.get_local_rank()
    placed = local.new_zeros((n * mesh.size(), *local.shape[1:]))
    placed[rank * n:(rank + 1) * n] = local
    dist.all_reduce(placed, op=dist.ReduceOp.SUM, group=mesh.get_group())
    return placed


def _reduce(mesh: DeviceMesh, x: torch.Tensor, op) -> torch.Tensor:
    dist.all_reduce(x, op=op, group=mesh.get_group())
    return x


class BatchedForce:
    """(B, H, W, 3) uint8 ref/def stacks -> per-stream force scalars and
    heightmaps, on the device of ``pipe``.

    Keeps the JAX defaults: a 2 mm grating pitch, a 0.01 mm contact
    threshold, and a 1e-9 floor on the period (``ForcePipeline`` uses
    1e-12)."""

    def __init__(self, pipe: FTPPipeline, force_model: Dict[str, Any],
                 grating_pitch_mm: float = 2.0, depth_eps_mm: float = 0.01):
        self.pipe = pipe
        self.force_model = force_model
        self.grating_pitch_mm = grating_pitch_mm
        self.depth_eps_mm = depth_eps_mm
        self.device = pipe.device

    def _single(self, ref_bgr, def_bgr) -> Dict[str, torch.Tensor]:
        """One stream's forward and volume -> force tail, on the device."""
        pipe = self.pipe
        res = pipe.forward(pipe.upload(ref_bgr), pipe.upload(def_bgr))
        height = res["height_map_mm_crop"]
        mm_per_px = self.grating_pitch_mm / torch.clamp(res["est_period_px"], min=1e-9)
        v, a, d = depth_map_to_volume_cm3(height, torch.isfinite(height), mm_per_px,
                                          self.depth_eps_mm)
        return {
            "force_N": scalar_models.predict_force_from_volume(self.force_model, v),
            "volume_cm3": v,
            "contact_area_mm2": a,
            "max_depth_mm": d,
            "height_map_mm": height,
        }

    def batched(self):
        """A callable from (B, H, W, 3) uint8 ref and def stacks (numpy or
        device tensors) to a dict of stacked device tensors: (B,) scalars
        and the (B, crop_h, crop_w) heightmaps."""
        def fn(refs, frames):
            refs, frames = self.pipe.upload(refs), self.pipe.upload(frames)
            if refs.dim() != 4 or refs.shape != frames.shape:
                raise ValueError(f"expected two (B, H, W, 3) stacks, got "
                                 f"{tuple(refs.shape)} and {tuple(frames.shape)}")
            outs = [self._single(refs[b], frames[b]) for b in range(frames.shape[0])]
            return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}
        return fn

    def sharded(self, mesh: DeviceMesh):
        """``batched()`` over this rank's local streams (``shard_batch`` or
        ``shard_local_batch``), for a pipeline on the rank's device; the
        results are the local streams', on that device."""
        dev = torch.device(self.device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        if dev != mesh_device(mesh):
            raise ValueError(f"the pipeline is on {dev}, this rank's device is "
                             f"{mesh_device(mesh)}")
        return self.batched()


def _local_streams(batched_force, mesh: DeviceMesh, ref_local, def_local, map_stride: int):
    """This rank's streams through ``batched_force._single``: the stacked
    force, area and depth scalars and each stream's contact-depth map on the
    rank's device.  The indentation side is detected per stream as
    ``depth_map_to_volume_cm3`` detects it (whichever of +Z and -Z
    integrates larger), so the map holds with
    ``mm_keep_indentation_negative=True``."""
    dev = mesh_device(mesh)
    ref_local, def_local = _on(mesh, ref_local), _on(mesh, def_local)
    outs = [batched_force._single(ref_local[b], def_local[b])
            for b in range(ref_local.shape[0])]
    if not outs:
        raise ValueError("a rank needs at least one stream")
    res = {k: torch.stack([o[k] for o in outs]).to(dev)
           for k in ("force_N", "contact_area_mm2", "max_depth_mm", "height_map_mm")}
    hm = res["height_map_mm"]
    finite = torch.isfinite(hm)
    hmf = torch.where(finite, hm, 0.0)
    pos_sum = torch.clamp(hmf, min=0.0).sum(dim=(1, 2), keepdim=True)
    neg_sum = torch.clamp(-hmf, min=0.0).sum(dim=(1, 2), keepdim=True)
    depth = torch.where(neg_sum > pos_sum, -hmf, hmf)
    contact = torch.where(finite & (depth > batched_force.depth_eps_mm), depth, 0.0)
    if map_stride > 1:
        contact = contact[:, ::map_stride, ::map_stride].contiguous()
    return res["force_N"], res["contact_area_mm2"], res["max_depth_mm"], contact


def whole_limb_step(batched_force, mesh: DeviceMesh, map_stride: int = 1):
    """Multi-stream fusion head (BASELINE.json config 5).

    Returns ``step(ref_local, def_local) -> dict``: the rank's (n, H, W, 3)
    uint8 streams (``shard_batch`` / ``shard_local_batch``) through
    ``batched_force._single`` (any object with it and ``depth_eps_mm``),
    then the head over the mesh.  Every rank receives the same dict:
    ``per_stream_force`` (B,), ``total_force_N``, ``max_depth_mm`` and
    ``contact_area_mm2`` (0-d: sums of the local sums, the max of the local
    maxima), and ``whole_limb_map_mm`` (B, h', w'): each stream's contact
    depth (depth > ``depth_eps_mm``, else 0) subsampled by ``map_stride``.
    All float32, on the rank's device."""
    def step(ref_local, def_local) -> Dict[str, torch.Tensor]:
        forces, areas, depths, maps = _local_streams(batched_force, mesh, ref_local,
                                                     def_local, map_stride)
        return {
            "per_stream_force": gather_streams(mesh, forces),
            "total_force_N": _reduce(mesh, forces.sum(), dist.ReduceOp.SUM),
            "max_depth_mm": _reduce(mesh, depths.max(), dist.ReduceOp.MAX),
            "contact_area_mm2": _reduce(mesh, areas.sum(), dist.ReduceOp.SUM),
            "whole_limb_map_mm": gather_streams(mesh, maps),
        }
    return step


def motion_gate(accel_mss: torch.Tensor, ok_mss: float = 2.0,
                cut_mss: float = 20.0) -> torch.Tensor:
    """Per-stream IMU motion gate in [0, 1]: 1 below ``ok_mss`` of residual
    acceleration, 0 above ``cut_mss``, linear between (a fast-moving patch
    is motion-blurred).  ``accel_mss``: (..., 3) gravity-removed
    acceleration [m/s^2]."""
    mag = torch.sqrt(torch.sum(torch.square(accel_mss), dim=-1))
    return torch.clamp((cut_mss - mag) / (cut_mss - ok_mss), 0.0, 1.0)


def whole_limb_step_aux(batched_force, mesh: DeviceMesh, canvas_hw, map_stride: int = 1,
                        gate_ok_mss: float = 2.0, gate_cut_mss: float = 20.0):
    """Config-5 fusion head with the proprioception and IMU streams.

    Returns ``step(ref_local, def_local, aux) -> dict``; ``aux`` holds the
    rank's ``pose_px`` (n, 2) int, the top-left (y, x) of each patch on the
    limb canvas in canvas pixels at stride 1, and ``accel_mss`` (n, 3), its
    gravity-removed acceleration.  Each stream is weighted by its
    ``motion_gate``; its contact map times the gate is max-blended onto a
    zero (canvas_h // map_stride, canvas_w // map_stride) canvas at
    ``pose // map_stride``, clipped to keep the patch inside, and the
    canvases are max-reduced over the mesh.  Every rank receives
    ``per_stream_force`` (gated) and ``stream_gate`` (B,), the gated
    ``total_force_N``, ``max_depth_mm`` and ``contact_area_mm2``, and
    ``limb_canvas_mm``.  The placement runs on the device (a max scatter,
    order-free and so exact): the poses are never read on the host."""
    ch, cw = int(canvas_hw[0]) // map_stride, int(canvas_hw[1]) // map_stride

    def step(ref_local, def_local, aux) -> Dict[str, torch.Tensor]:
        forces, areas, depths, maps = _local_streams(batched_force, mesh, ref_local,
                                                     def_local, map_stride)
        dev = forces.device
        gate = motion_gate(_on(mesh, aux["accel_mss"]).to(torch.float32),
                           gate_ok_mss, gate_cut_mss)
        pose = _on(mesh, aux["pose_px"]).to(torch.int64)
        n, ph, pw = maps.shape
        if ph > ch or pw > cw:
            raise ValueError(f"a ({ph}, {pw}) patch does not fit the ({ch}, {cw}) canvas")
        yx = torch.div(pose, map_stride, rounding_mode="floor")
        yx = torch.minimum(torch.clamp(yx, min=0),
                           torch.tensor([ch - ph, cw - pw], device=dev))
        rows = yx[:, 0, None] + torch.arange(ph, device=dev)
        cols = yx[:, 1, None] + torch.arange(pw, device=dev)
        idx = rows[:, :, None] * cw + cols[:, None, :]
        canvas = torch.zeros(ch * cw, dtype=maps.dtype, device=dev)
        canvas.scatter_reduce_(0, idx.reshape(-1), (maps * gate[:, None, None]).reshape(-1),
                               "amax")
        gf = forces * gate
        return {
            "per_stream_force": gather_streams(mesh, gf),
            "stream_gate": gather_streams(mesh, gate),
            "total_force_N": _reduce(mesh, gf.sum(), dist.ReduceOp.SUM),
            "max_depth_mm": _reduce(mesh, (depths * gate).max(), dist.ReduceOp.MAX),
            "contact_area_mm2": _reduce(mesh, (areas * gate).sum(), dist.ReduceOp.SUM),
            "limb_canvas_mm": _reduce(mesh, canvas.view(ch, cw), dist.ReduceOp.MAX),
        }
    return step
