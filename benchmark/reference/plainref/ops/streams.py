"""The stream axis of a batched forward (``jax.vmap`` of the force forward).

``FTPPipeline.forward_eager`` on (B, H, W, 3) stacks runs every op once over
arrays with a leading stream axis.  A few ops would give a stream other bits
than its single forward if they ran once over the stack: a float reduction
over a plane and a matrix product whose rows fold the leading axes (the
library picks its kernel and its order of summation by the size of the
call, on the card and on a multi-threaded CPU), and, on the CPU only, an
FFT (the CPU library's vectorised transforms).  Those ops take a
``streams`` flag, passed down from the forward that knows the stream axis,
and run through ``each``: once a stream where it is set, else one call.
So each stream of a batch gets its single forward's bits.  A device loop
over a stack (``keep_live``) writes only the live solves' state.
"""
from __future__ import annotations

from typing import Callable

import torch


def each(fn: Callable, *xs: torch.Tensor, streams: bool, cpu_only: bool = False):
    """``fn(*xs)``, or with ``streams`` (the inputs' leading axis is the
    stream axis) ``fn`` of each stream's slice of ``xs``, the results (a
    tensor or a tuple of them) stacked along it.  With ``cpu_only`` the
    split is made on the CPU only."""
    if not streams or (cpu_only and xs[0].device.type != "cpu"):
        return fn(*xs)
    n = xs[0].shape[0]
    if any(x.dim() < 1 or x.shape[0] != n for x in xs):
        raise ValueError(f"each: inputs {[tuple(x.shape) for x in xs]} share no leading "
                         f"stream axis")
    outs = [fn(*parts) for parts in zip(*(x.unbind(0) for x in xs))]
    if isinstance(outs[0], tuple):
        return tuple(torch.stack(o) for o in zip(*outs))
    return torch.stack(outs)


def keep_live(live: torch.Tensor, new: torch.Tensor, old: torch.Tensor) -> torch.Tensor:
    """A batched loop's update of one state tensor: ``new`` for the solves
    of the (B,) mask ``live``, ``old`` for the others (the per-stream select
    of ``jax.vmap`` of a ``lax.while_loop``), over (B, ...) state."""
    return torch.where(live.reshape(live.shape + (1,) * (old.dim() - live.dim())), new, old)
