"""One forward captured into a CUDA graph and replayed (the port's
counterpart of the JAX package's ``jax.jit`` of a whole forward).

    graph = ForwardGraph(pipe.forward_eager, device)
    out = graph(ref, de)      # first call: eager, then the capture
    out = graph(ref2, de2)    # later calls: one replay

The first call copies its inputs into static buffers, runs the forward
eagerly on them (which builds every lazily made constant, the cuFFT plans
and the kernel library outside the graph) and returns that result; then it
captures the same forward into a ``torch.cuda.CUDAGraph`` on PyTorch's
capture stream, with the garbage collector held off.  The capture runs
nothing: the ``kernels.launch`` counts it makes are taken back and added
once for each replay instead (``kernels.count_replay``).  Every later call copies its inputs into the
static buffers, replays the graph on the current stream and returns clones
of the static outputs, which the next replay overwrites.  Inputs of another
shape, dtype or device raise; so does a failed capture or replay: nothing
runs the forward eagerly instead.
"""
from __future__ import annotations

import gc
from typing import Callable, Dict, Optional, Sequence

import torch

from vistaf_torch import kernels


class ForwardGraph:
    """``fn(*inputs) -> {name: tensor}`` captured once and replayed."""

    def __init__(self, fn: Callable[..., Dict[str, torch.Tensor]], device):
        self.fn = fn
        self.device = torch.device(device)
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.launches: Dict[str, int] = {}
        self._inputs: Sequence[torch.Tensor] = ()
        self._outputs: Dict[str, torch.Tensor] = {}

    def __call__(self, *inputs: torch.Tensor) -> Dict[str, torch.Tensor]:
        if self.graph is None:
            return self._capture(inputs)
        if len(inputs) != len(self._inputs) or any(
                x.shape != s.shape or x.dtype != s.dtype or x.device != s.device
                for x, s in zip(inputs, self._inputs)):
            raise ValueError(
                "the forward's CUDA graph was captured for inputs "
                f"{[(tuple(s.shape), s.dtype, str(s.device)) for s in self._inputs]}, got "
                f"{[(tuple(x.shape), x.dtype, str(x.device)) for x in inputs]}")
        for s, x in zip(self._inputs, inputs):
            s.copy_(x)
        self.graph.replay()
        kernels.count_replay(self.launches)
        return {k: v.clone() for k, v in self._outputs.items()}

    def _capture(self, inputs) -> Dict[str, torch.Tensor]:
        with torch.cuda.device(self.device):
            self._inputs = [torch.empty_like(x, device=self.device).copy_(x) for x in inputs]
            out = self.fn(*self._inputs)
            before = dict(kernels.LAUNCHES)
            graph = torch.cuda.CUDAGraph()
            # no garbage collection inside the capture: freeing a cycle
            # there (a profiler, CUDA events, pinned buffers) makes CUDA
            # calls that invalidate it.  Other threads' calls (NCCL's
            # watchdog) do not concern it ("thread_local"); this thread's
            # host reads still fail the capture.
            enabled = gc.isenabled()
            gc.collect()
            gc.disable()
            try:
                with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                    self._outputs = self.fn(*self._inputs)
            finally:
                if enabled:
                    gc.enable()
            self.launches = {k: v - before[k] for k, v in kernels.LAUNCHES.items()
                             if v != before[k]}
            kernels.LAUNCHES.update(before)
        self.graph = graph
        return out
