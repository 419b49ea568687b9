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
runs the forward eagerly instead.  While ``utils/profiling.py``'s
recorder is on, the first call's eager run and capture are the spans
``eager`` and ``capture``, and a later call is a ``replay`` span whose
replay is timed on the card and counts the condition setter's runs by site
(``profiling.on_device``).

The forward's data-dependent loops and branches stay on the device, as the
JAX package's ``lax.while_loop`` and ``lax.cond`` do inside its jitted
forward: ``device_while(cond, body, state, site=...)`` and
``device_if(pred, fn, out, site=...)``, ``site`` naming the setter's slot
that counts the node's runs.  Under a capture each is a CUDA-graph
conditional node (a WHILE or an IF node, ``kernels/graph_cond_kernel.py``)
whose body is captured once on a stream of its own, its condition set on
the card; anywhere else (on the CPU, in the card's eager forward) each is
its plain version, ``while cond(state): body(state)`` and ``if pred:
fn(out)``, with the predicate read on the host and the same ops in the
same order.  A body
updates its tensors in place: the body graph replays on fixed buffers, so
it may not rebind its state, read the device on the host or build a tensor
from host values.  Its temporaries live in a memory pool that lives as
long as the graph (``ForwardGraph.body_pool``).  A graph goes with its
``ForwardGraph``, but one that holds a WHILE node is kept for the life of
the process once ``torch.profiler`` has traced the card in it
(``_RETAINED``: a profiler fault, see there).
"""
from __future__ import annotations

import contextlib
import gc
import threading
import weakref
from typing import Callable, Dict, List, Optional, Sequence

import torch

from vistaf_torch import kernels
from vistaf_torch.kernels import graph_cond_kernel
from vistaf_torch.utils import profiling

_BODY_POOL = threading.local()    # .pool: the memory pool of the capture's bodies
_BODY_STREAMS: Dict[int, torch.cuda.Stream] = {}
# Graphs that hold a WHILE node, with their body pools, whose ForwardGraph
# went after torch.profiler had traced the card in this process: kept for
# the life of the process.  Destroying one there once made the first
# profiled replay of another graph with conditional nodes segfault in
# cudaGraphLaunch (PyTorch 2.11.0+cu128, driver 580.159.03, NVIDIA H100).
# In a process that has not traced, destroying them has not faulted
# (scripts/torch_graph_lifetime.py), so there they go with their graph.
_RETAINED: List[tuple] = []
_WHILE_NODES = [0]                # WHILE nodes captured in this process
_PROFILED = [False]               # torch.profiler has traced the card here


def note_profiler() -> None:
    """Record that ``torch.profiler`` is about to trace the card: from then
    on a WHILE graph whose ``ForwardGraph`` goes is kept (``_RETAINED``).
    ``utils/profiling.py`` calls it before every trace; code that traces
    with ``torch.profiler`` itself calls it first.  (PyTorch loads the CUPTI
    library when it is imported, so the process cannot tell otherwise.)"""
    _PROFILED[0] = True


def _release(graph: torch.cuda.CUDAGraph, body_pool) -> None:
    """A WHILE graph's ForwardGraph has gone: keep the graph and its body
    pool if a profiler has traced the card, else let them go."""
    if _PROFILED[0]:
        _RETAINED.append((graph, body_pool))


def _capturing(t: torch.Tensor) -> bool:
    return t.device.type == "cuda" and torch.cuda.is_current_stream_capturing()


@contextlib.contextmanager
def conditional_bodies(device):
    """Enter before a capture that may hold ``device_while`` or
    ``device_if``: yields the memory pool their bodies' temporaries are
    allocated from, which must live as long as the graph.  Makes the
    device's body stream first, outside any capture, with its cuBLAS
    workspace."""
    device = torch.device(device)
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if device.index not in _BODY_STREAMS:
        s = torch.cuda.Stream(device)
        s.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(s):
            a = torch.ones((8, 8), device=device)
            (a @ a).sum()
        torch.cuda.current_stream(device).wait_stream(s)
        _BODY_STREAMS[device.index] = s
    pool = torch.cuda.MemPool()
    prev = getattr(_BODY_POOL, "pool", None)
    _BODY_POOL.pool = pool
    try:
        yield pool
    finally:
        _BODY_POOL.pool = prev


def _conditional_node(kind: int, pred: torch.Tensor, body: Callable[[], None], site: str,
                      again: Optional[Callable[[], torch.Tensor]] = None) -> None:
    """Capture an IF or WHILE node on the current stream: the setter with
    ``pred``, the node, then ``body()`` (and, for a WHILE node, the setter
    with ``again()``) captured into its body graph on the body stream.  The
    setter counts in ``site``'s slot, but a WHILE node's first set, which
    counts in ``entry``."""
    device = pred.device
    pool = getattr(_BODY_POOL, "pool", None)
    stream = _BODY_STREAMS.get(device.index)
    if pool is None or stream is None:
        raise RuntimeError("device_while/device_if under a capture need "
                           "cuda_graph.conditional_bodies around it")
    if torch.cuda.current_stream(device) == stream:
        raise RuntimeError("a conditional node inside another one's body is not supported")
    handle = graph_cond_kernel.create_handle(device)
    graph_cond_kernel.set_conditional(handle, pred, "entry" if again is not None else site)
    graph_cond_kernel.begin_body(handle, kind, stream, device)
    try:
        with torch.cuda.stream(stream), torch.cuda.use_mem_pool(pool, device):
            body()
            if again is not None:
                graph_cond_kernel.set_conditional(handle, again(), site)
    finally:
        graph_cond_kernel.end_body(stream)


def _check_site(site: str) -> None:
    if site not in graph_cond_kernel.SITES or site == "entry":
        raise ValueError(f"site {site!r}: one of {graph_cond_kernel.SITES[1:]}")


def device_while(cond: Callable[[Sequence[torch.Tensor]], torch.Tensor],
                 body: Callable[[Sequence[torch.Tensor]], None],
                 state: Sequence[torch.Tensor], *, site: str) -> None:
    """``lax.while_loop`` on the device: ``body(state)`` updates the state
    tensors in place while ``cond(state)`` (a 0-dim bool tensor) holds.
    Under a capture a WHILE node whose trips count in the setter's slot
    ``site`` (``graph_cond_kernel.SITES``); else ``while cond(state):
    body(state)``, the condition read on the host
    (``set_conditional_plain``)."""
    _check_site(site)
    if _capturing(state[0]):
        _conditional_node(graph_cond_kernel.WHILE, cond(state), lambda: body(state), site,
                          lambda: cond(state))
        _WHILE_NODES[0] += 1
        return
    while graph_cond_kernel.set_conditional_plain(cond(state)):
        body(state)


def device_if(pred: torch.Tensor, fn: Callable[[torch.Tensor], None],
              out: torch.Tensor, *, site: str) -> None:
    """``lax.cond`` on the device: ``fn(out)`` updates ``out`` in place if
    the 0-dim bool ``pred`` holds.  Under a capture an IF node whose runs
    count in the setter's slot ``site``; else ``if pred: fn(out)``, the
    predicate read on the host."""
    _check_site(site)
    if _capturing(pred):
        _conditional_node(graph_cond_kernel.IF, pred, lambda: fn(out), site)
        return
    if graph_cond_kernel.set_conditional_plain(pred):
        fn(out)


def _clone(out):
    """A copy of ``out``: a tensor, or a dict, tuple or list of them."""
    if isinstance(out, torch.Tensor):
        return out.clone()
    if isinstance(out, dict):
        return {k: _clone(v) for k, v in out.items()}
    return type(out)(_clone(v) for v in out)


class ForwardGraph:
    """``fn(*inputs) -> outputs`` captured once and replayed: the outputs a
    dict of tensors, or dicts, tuples and lists of them."""

    def __init__(self, fn: Callable, device):
        self.fn = fn
        self.device = torch.device(device)
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.launches: Dict[str, int] = {}
        self._inputs: Sequence[torch.Tensor] = ()
        self._outputs = None
        self.body_pool = None

    def __call__(self, *inputs: torch.Tensor):
        if self.graph is None:
            return self._capture(inputs)
        if len(inputs) != len(self._inputs) or any(
                x.shape != s.shape or x.dtype != s.dtype or x.device != s.device
                for x, s in zip(inputs, self._inputs)):
            raise ValueError(
                "the forward's CUDA graph was captured for inputs "
                f"{[(tuple(s.shape), s.dtype, str(s.device)) for s in self._inputs]}, got "
                f"{[(tuple(x.shape), x.dtype, str(x.device)) for x in inputs]}")
        with profiling.span("replay") as sp:
            for s, x in zip(self._inputs, inputs):
                s.copy_(x)
            with profiling.on_device(sp, self.device):
                self.graph.replay()
            kernels.count_replay(self.launches)
            return _clone(self._outputs)

    def _capture(self, inputs):
        with torch.cuda.device(self.device):
            self._inputs = [torch.empty_like(x, device=self.device).copy_(x) for x in inputs]
            with profiling.span("eager"):
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
            whiles = _WHILE_NODES[0]
            try:
                with profiling.span("capture"), \
                        conditional_bodies(self.device) as self.body_pool, \
                        torch.cuda.graph(graph, capture_error_mode="thread_local"):
                    self._outputs = self.fn(*self._inputs)
            finally:
                if enabled:
                    gc.enable()
            if _WHILE_NODES[0] != whiles:
                weakref.finalize(self, _release, graph, self.body_pool)
            self.launches = {k: v - before[k] for k, v in kernels.LAUNCHES.items()
                             if v != before[k]}
            kernels.LAUNCHES.update(before)
        self.graph = graph
        return out
