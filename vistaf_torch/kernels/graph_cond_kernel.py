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
It adds one to its call site's slot on the card each time it runs instead
(``SITES``; ``slots``, ``sets``, ``reset_sets``), so a replay's setter runs
are counted exactly and by site: the setter before a WHILE node counts in
``entry``, so a WHILE site's slot holds its trips, and an IF site's slot
its nodes' runs.  Nothing here runs on the CPU: a CPU forward never
captures.
"""
from __future__ import annotations

import ctypes

import torch

from vistaf_torch import kernels

IF, WHILE = 0, 1
# the setter's slots on the card (csrc/graph_cond.cu kSlots): each WHILE
# node's first set, the ECC Gauss-Newton loop's trips
# (kernels/ecc_kernel.gn_loop), the WLS unwrap's PCG trips
# (ops/unwrap._wls_pcg_solve), the dominant component's seed pick
# (ops/components.dominant_component) and the temperature shear fold
# (temperature/inference.oriented_gaussian_blur)
SITES = ("entry", "ecc", "pcg", "seed", "fold")


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


def set_conditional(handle: int, pred: torch.Tensor, site: str) -> None:
    """Launch the setter on the current stream: the handle's value becomes
    the 0-dim boolean ``pred`` when it runs, and ``site``'s slot counts the
    run."""
    if pred.device.type != "cuda" or pred.dtype != torch.bool or pred.numel() != 1:
        raise ValueError(f"set_conditional: a one-element bool tensor on the card, got "
                         f"{pred.dtype} {tuple(pred.shape)} on {pred.device}")
    with torch.cuda.device(pred.device):
        _check("vt_set_conditional", kernels.library().vt_set_conditional(
            handle, pred.data_ptr(), SITES.index(site), _stream(pred.device)))


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


def _library() -> ctypes.CDLL:
    lib = kernels.library()
    if lib.vt_cond_slot_count() != len(SITES):
        raise RuntimeError(f"csrc/graph_cond.cu has {lib.vt_cond_slot_count()} slots, "
                           f"SITES {len(SITES)}")
    return lib


def slots(device) -> dict:
    """The setter's runs on ``device`` since ``reset_sets``, by site (a host
    read)."""
    n = (ctypes.c_ulonglong * len(SITES))()
    with torch.cuda.device(device):
        torch.cuda.synchronize(device)
        _check("vt_cond_slots", _library().vt_cond_slots(n))
    return dict(zip(SITES, n))


def slots_async(out: torch.Tensor, device) -> None:
    """Enqueue a copy of the slots into ``out`` (pinned int64 host memory,
    one element a site) on ``device``'s current stream."""
    if out.device.type != "cpu" or not out.is_pinned() or out.dtype != torch.int64 \
            or out.numel() != len(SITES) or not out.is_contiguous():
        raise ValueError(f"slots_async: a pinned int64 host tensor of {len(SITES)}")
    with torch.cuda.device(device):
        _check("vt_cond_slots_async",
               _library().vt_cond_slots_async(out.data_ptr(), _stream(torch.device(device))))


def sets(device) -> int:
    """The setter's runs on ``device`` since ``reset_sets``, over every
    site (a host read)."""
    return sum(slots(device).values())


def reset_sets(device) -> None:
    """Zero every site's slot."""
    with torch.cuda.device(device):
        torch.cuda.synchronize(device)
        _check("vt_cond_slots_reset", _library().vt_cond_slots_reset())
