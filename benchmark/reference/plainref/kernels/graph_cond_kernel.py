"""The condition setter of a CUDA-graph conditional node
(``csrc/graph_cond.cu``), and the host calls that add IF and WHILE nodes
to a graph being captured.

Replaces no Pallas kernel: the JAX package runs its ECC and PCG loops as
``lax.while_loop`` and its seed pick as a ``lax.cond`` inside its compiled
forward; ``utils/cuda_graph.py::device_while`` and ``device_if`` put them
into the port's captured forward as WHILE and IF nodes through the calls
below.  The plain version of the setter is the host read of the predicate
(``set_conditional_plain``), which the loops' plain forms take instead.

The setter does not count itself in ``kernels.LAUNCHES``: a setter captured
at the end of a WHILE body runs once a trip, a number the host never sees.
It adds one to a counter on the card each time it runs instead
(``sets``, ``reset_sets``), so a replay's setter runs are counted
exactly.  Nothing here runs on the CPU: a CPU forward never captures.
"""
from __future__ import annotations

import ctypes

import torch

from plainref import kernels

IF, WHILE = 0, 1


def _check(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err}")


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def set_conditional_plain(pred: torch.Tensor) -> bool:
    """Plain version of the setter: the predicate read on the host."""
    return bool(pred)


def create_handle(device: torch.device) -> int:
    """A conditional handle on the graph that ``device``'s current stream
    is capturing into (raises unless it is capturing)."""
    h = ctypes.c_ulonglong(0)
    with torch.cuda.device(device):
        _check("vt_cond_handle", kernels.library().vt_cond_handle(ctypes.byref(h),
                                                                  _stream(device)))
    return h.value


def set_conditional(handle: int, pred: torch.Tensor) -> None:
    """Launch the setter on the current stream: the handle's value becomes
    the 0-dim boolean ``pred`` when it runs."""
    if pred.device.type != "cuda" or pred.dtype != torch.bool or pred.numel() != 1:
        raise ValueError(f"set_conditional: a one-element bool tensor on the card, got "
                         f"{pred.dtype} {tuple(pred.shape)} on {pred.device}")
    with torch.cuda.device(pred.device):
        _check("vt_set_conditional", kernels.library().vt_set_conditional(
            handle, pred.data_ptr(), _stream(pred.device)))


def begin_body(handle: int, kind: int, body_stream: torch.cuda.Stream,
               device: torch.device) -> None:
    """Add an IF or WHILE node (``kind``) on ``handle`` after the current
    stream's captured work and begin capturing ``body_stream`` into its
    body."""
    with torch.cuda.device(device):
        _check("vt_cond_begin", kernels.library().vt_cond_begin(
            handle, kind, body_stream.cuda_stream, _stream(device)))


def end_body(body_stream: torch.cuda.Stream) -> None:
    _check("vt_cond_end", kernels.library().vt_cond_end(body_stream.cuda_stream))


def sets(device) -> int:
    """The setter's runs on ``device`` since ``reset_sets`` (a host read)."""
    n = ctypes.c_ulonglong(0)
    with torch.cuda.device(device):
        torch.cuda.synchronize(device)
        _check("vt_cond_sets", kernels.library().vt_cond_sets(ctypes.byref(n)))
    return n.value


def reset_sets(device) -> None:
    with torch.cuda.device(device):
        torch.cuda.synchronize(device)
        _check("vt_cond_sets_reset", kernels.library().vt_cond_sets_reset())
