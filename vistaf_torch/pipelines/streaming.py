"""Streaming multi-patch inference with temporal smoothing (JAX
``pipelines/streaming.py``).

BASELINE config 4: several skin-camera streams, each frame batch through
the batched force forward, then a ring buffer of the last K per-stream
force readings with median / mean / EMA smoothing and contact-state
hysteresis.  The state is an explicit tuple of device tensors, all float32
but the frame count (int32) and the contact flags (bool); ``update`` makes
no host copy.  On the card a ``StreamingForce`` step is one CUDA graph, as
the JAX package jits its step: the batch's forwards, the gathers over a
mesh and ``update``, the state kept in fixed device buffers that the graph
rewrites in place.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from vistaf_torch.parallel.mesh import gather_streams, mesh_device
from vistaf_torch.utils import profiling
from vistaf_torch.utils.cuda_graph import ForwardGraph


class StreamState(NamedTuple):
    ring: torch.Tensor        # (n_streams, window) recent force readings
    count: torch.Tensor       # () frames seen, int32
    ema: torch.Tensor         # (n_streams,) exponential moving average
    in_contact: torch.Tensor  # (n_streams,) bool hysteresis state


def init_state(n_streams: int, window: int = 8, device="cuda") -> StreamState:
    dev = torch.device(device)
    return StreamState(
        ring=torch.zeros((n_streams, window), dtype=torch.float32, device=dev),
        count=torch.zeros((), dtype=torch.int32, device=dev),
        ema=torch.zeros((n_streams,), dtype=torch.float32, device=dev),
        in_contact=torch.zeros((n_streams,), dtype=torch.bool, device=dev),
    )


def _sum_in_order(x: torch.Tensor) -> torch.Tensor:
    """x[0] + x[1] + ... left to right: the same bits on every device
    (a tensor reduction's order differs between the CPU and the card)."""
    total = x[0]
    for row in x[1:]:
        total = total + row
    return total


def update(state: StreamState, forces: torch.Tensor, ema_alpha: float = 0.2,
           contact_on_N: float = 0.3, contact_off_N: float = 0.1
           ) -> Tuple[StreamState, Dict[str, torch.Tensor]]:
    """One streaming step: write the per-stream forces into ring slot
    ``count % window`` and return the new state and the smoothed readings.

    Mean and median run over the filled part of the ring; the median is the
    sorted ring, 3e38 in the empty slots, at index (min(count, window) - 1)
    // 2.  The EMA starts from the first forces.  Contact switches on above
    0.3 N and off at or below 0.1 N of the median.  The sums run left to
    right, so the card and the CPU give the same bits."""
    ring0 = state.ring
    n, window = ring0.shape
    forces = forces.to(device=ring0.device, dtype=torch.float32)
    idx = torch.arange(window, dtype=torch.int32, device=ring0.device)
    ring = torch.where(idx == torch.remainder(state.count, window), forces[:, None], ring0)
    count = state.count + 1

    filled = torch.clamp(count, max=window)
    valid = idx < filled
    mean = _sum_in_order(torch.where(valid, ring, 0.0).T) / torch.clamp(
        filled.to(torch.float32), min=1.0)
    sorted_ring = torch.sort(torch.where(valid, ring, 3e38), dim=1).values
    mid = torch.div(filled - 1, 2, rounding_mode="floor").to(torch.int64)
    median = torch.gather(sorted_ring, 1, mid.expand(n, 1))[:, 0]

    ema = torch.where(count == 1, forces,
                      (1.0 - ema_alpha) * state.ema + ema_alpha * forces)
    in_contact = torch.where(state.in_contact, median > contact_off_N,
                             median > contact_on_N)

    out = {
        "force_mean_N": mean,
        "force_median_N": median,
        "force_ema_N": ema,
        "in_contact": in_contact,
        "total_force_N": _sum_in_order(median),
    }
    return StreamState(ring, count, ema, in_contact), out


def _to_host(outs: List[Dict[str, torch.Tensor]]) -> List[Dict[str, np.ndarray]]:
    """Device outputs of many steps to numpy, one copy per key."""
    if not outs:
        return []
    if len(outs) == 1:         # no stack: a step's fetch launches nothing
        return [{k: v.cpu().numpy()[()] for k, v in outs[0].items()}]
    stacked = {k: torch.stack([o[k] for o in outs]).cpu().numpy() for k in outs[0]}
    return [{k: v[i] for k, v in stacked.items()} for i in range(len(outs))]


class StreamingForce:
    """Batched force forward + temporal smoothing over a stream batch, on
    the device of ``batched_force`` (the card unless its pipeline was built
    for another).

    With a ``mesh`` (``parallel.make_stream_mesh``) each rank is given its
    own n_streams / world streams (``shard_batch``) and runs them on its
    device; their raw forces and depths are gathered over the mesh, and
    every rank keeps the same replicated smoothing state of all
    ``n_streams`` and returns the same outputs.

    A step is ``step_eager``: the batch through the force's
    ``batched_eager`` (a stand-in force without one: its ``batched()``),
    the gathers and ``update``, the new state copied into the state's
    buffers.  Where ``graph_route`` holds (on the card, over a CUDA mesh or
    none, with a force whose forwards replay graphs) every step is one
    replay of a CUDA graph of it, captured at the first call; elsewhere
    ``step_eager`` runs."""

    def __init__(self, batched_force, n_streams: int, window: int = 8,
                 ema_alpha: float = 0.2, mesh=None):
        self.n_streams = n_streams
        self.ema_alpha = ema_alpha
        self._mesh = mesh
        if mesh is None:
            self.device = torch.device(batched_force.device)
        else:
            if n_streams % mesh.size():
                raise ValueError(f"{n_streams} streams do not split over {mesh.size()} ranks")
            self.device = mesh_device(mesh)
        self._force = batched_force
        self._batch = getattr(batched_force, "batched_eager", None) or batched_force.batched()
        self._state = init_state(n_streams, window, self.device)
        self._graph: Optional[ForwardGraph] = None

    def graph_route(self) -> bool:
        """Whether a step replays a CUDA graph."""
        return (self.device.type == "cuda"
                and (self._mesh is None or self._mesh.device_type == "cuda")
                and self._force.graph_route())

    def _upload(self, x) -> torch.Tensor:
        if isinstance(x, torch.Tensor):
            return x.to(self.device)
        return torch.as_tensor(np.ascontiguousarray(x), device=self.device)

    def step_eager(self, refs: torch.Tensor, frames: torch.Tensor) -> Dict[str, torch.Tensor]:
        """One step op by op on device stacks: what the step's graph
        captures.  The state's buffers are rewritten in place, so a graph
        replays on the same ones."""
        res = self._batch(refs, frames)
        forces, depths = res["force_N"], res["max_depth_mm"]
        if self._mesh is not None:
            forces = gather_streams(self._mesh, forces.to(self.device))
            depths = gather_streams(self._mesh, depths.to(self.device))
        new, out = update(self._state, forces, self.ema_alpha)
        for buf, value in zip(self._state, new):
            buf.copy_(value)
        out["force_raw_N"] = forces
        out["max_depth_mm"] = depths
        return out

    def _step(self, refs: torch.Tensor, frames: torch.Tensor) -> Dict[str, torch.Tensor]:
        if self.graph_route():
            if self._graph is None:
                self._graph = ForwardGraph(self.step_eager, self.device)
            return self._graph(refs, frames)
        with profiling.span("eager"):
            return self.step_eager(refs, frames)

    def __call__(self, refs, frames) -> Dict[str, np.ndarray]:
        """One batch of (n_streams, H, W, 3) uint8 frames against the
        streams' reference frames (this rank's block of both over a mesh);
        returns the step's outputs, of every stream, as numpy.  The span
        ``stream_step``, holding ``upload``, ``replay`` (or ``eager``) and
        ``fetch``."""
        with profiling.span("stream_step"):
            with profiling.span("upload"):
                refs, frames = self._upload(refs), self._upload(frames)
            out = self._step(refs, frames)
            with profiling.span("fetch"):
                return _to_host([out])[0]

    def reset(self, window: Optional[int] = None) -> None:
        """Back to no frames seen.  The same window zeroes the state's
        buffers in place (a captured step keeps them); another window makes
        new ones and drops the step's graph."""
        w = window or self._state.ring.shape[1]
        if w == self._state.ring.shape[1]:
            for buf in self._state:
                buf.zero_()
            return
        self._state = init_state(self.n_streams, w, self.device)
        self._graph = None

    # ------------------------------------------------------------------
    def run_overlapped(self, refs, frames_seq) -> List[Dict[str, np.ndarray]]:
        """Drive a sequence of (n_streams, H, W, 3) uint8 batches with
        double-buffered ingest: on the card, batch N+1 is copied from pinned
        host memory on a second CUDA stream while batch N computes, with
        events ordering each copy before its use and each use before the
        next copy into the same buffers.  The outputs are fetched once, at
        the end.  Elsewhere the batches run one after the other.  The span
        ``run_overlapped``, holding ``upload`` (the references), ``stage``
        a batch (its wait for the pinned buffer's previous copy
        ``stage_wait``), ``replay`` (or ``eager``) a step and one
        ``fetch``."""
        with profiling.span("run_overlapped"):
            with profiling.span("upload"):
                refs_dev = self._upload(refs)
            outs = self._overlapped(refs_dev, frames_seq)
            with profiling.span("fetch"):
                return _to_host(outs)

    def _overlapped(self, refs_dev: torch.Tensor, frames_seq) -> List[Dict[str, torch.Tensor]]:
        it = iter(frames_seq)
        first = next(it, None)
        if first is None:
            return []
        if self.device.type != "cuda":
            outs = []
            for f in (first, *it):
                with profiling.span("stage"):
                    f = self._upload(f)
                outs.append(self._step(refs_dev, f))
            return outs

        first = np.ascontiguousarray(first)
        main = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        host = [torch.empty(first.shape, dtype=torch.uint8, pin_memory=True)
                for _ in range(2)]
        dev = [torch.empty(first.shape, dtype=torch.uint8, device=self.device)
               for _ in range(2)]
        copied = [torch.cuda.Event(), torch.cuda.Event()]
        consumed: List[Optional[torch.cuda.Event]] = [None, None]

        def stage(i: int, frames) -> None:
            with profiling.span("stage"):
                k = i % 2
                frames = np.ascontiguousarray(frames)
                if frames.shape != first.shape or frames.dtype != np.uint8:
                    raise ValueError(f"batch {i}: {frames.shape} {frames.dtype}, expected "
                                     f"{first.shape} uint8")
                if i >= 2:
                    with profiling.span("stage_wait"):
                        copied[k].synchronize()       # batch i-2's copy has left host[k]
                host[k].copy_(torch.from_numpy(frames))
                with torch.cuda.stream(side):
                    if consumed[k] is not None:
                        side.wait_event(consumed[k])   # batch i-2's step is done with dev[k]
                    dev[k].copy_(host[k], non_blocking=True)
                    copied[k].record(side)

        outs = []
        stage(0, first)
        i, nxt = 0, next(it, None)
        while True:
            if nxt is not None:
                stage(i + 1, nxt)                 # upload N+1 ...
            k = i % 2
            main.wait_event(copied[k])
            outs.append(self._step(refs_dev, dev[k]))   # ... while N computes
            consumed[k] = torch.cuda.Event()
            consumed[k].record(main)
            if nxt is None:
                break
            i, nxt = i + 1, next(it, None)
        return outs
