"""Multi-process bring-up of the stream mesh (JAX ``parallel/distributed.py``).

The port runs one process per card: each process drives its own card's
streams, and the whole-limb heads (``parallel/mesh.py``) fuse the per-stream
results with ``torch.distributed`` collectives over the default process
group.  The group is NCCL over the cards; gloo only where the caller asks for
the CPU (the tests).

Typical bring-up in each process, launched by ``torchrun``::

    from vistaf_torch.parallel.distributed import initialize_multihost
    initialize_multihost()                  # no-op single-process
    mesh = make_stream_mesh()               # spans every process's card

The environment is torchrun's: ``MASTER_ADDR`` and ``MASTER_PORT`` (the
coordinator), ``WORLD_SIZE``, ``RANK`` and ``LOCAL_RANK``, with the semantics
the JAX package gives its ``JAX_*`` variables.
"""
from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

DEFAULT_PORT = 29500      # torchrun's default MASTER_PORT


def _env_int(name: str) -> Optional[int]:
    """Integer env var, or None when unset/malformed (malformed values are
    ignored rather than crashing bring-up on every host)."""
    v = os.environ.get(name, "").strip()
    if not v:
        return None
    try:
        return int(v)
    except ValueError:
        return None


def is_multihost_env() -> bool:
    """True when torchrun's multi-process environment is present: a
    coordinator address, or more than one process."""
    if os.environ.get("MASTER_ADDR"):
        return True
    n = _env_int("WORLD_SIZE")
    return bool(n and n > 1)


def backend_for(device) -> str:
    """The process group's backend for ``device``: NCCL on a card (raising
    where there is no card or no NCCL; never gloo on a card), gloo on the
    CPU."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return "gloo"
    if dev.type != "cuda":
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    if not torch.cuda.is_available():
        raise RuntimeError("device='cuda' but CUDA is not available")
    if not dist.is_nccl_available():
        raise RuntimeError("NCCL is not available: the card's group needs it")
    return "nccl"


def _init_method(address: str) -> str:
    return address if "://" in address else f"tcp://{address}"


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         device: str = "cuda") -> bool:
    """Bring up the default process group when (and only when) a
    multi-process environment is configured; a safe no-op otherwise.

    ``coordinator_address`` is ``host:port`` (or a ``tcp://`` URL); explicit
    arguments override the environment.  On ``device="cuda"`` the group is
    NCCL and this rank's card, ``cuda:LOCAL_RANK`` (the rank modulo the
    cards when ``LOCAL_RANK`` is unset), becomes the current device; NCCL
    missing raises, there is no gloo fallback on the card.  ``device="cpu"``
    takes gloo.  Returns True once the group is up; a second call (or a call
    with a group already up) is a no-op that returns True."""
    explicit = (coordinator_address is not None or num_processes is not None
                or process_id is not None)
    if not explicit and not is_multihost_env():
        return False
    if dist.is_initialized():
        return True
    backend = backend_for(device)
    world = num_processes if num_processes is not None else _env_int("WORLD_SIZE")
    rank = process_id if process_id is not None else _env_int("RANK")
    if world is None or rank is None:
        raise ValueError("the number of processes and this process's rank are not "
                         "known: pass them or set WORLD_SIZE and RANK")
    if coordinator_address is None:
        addr = os.environ.get("MASTER_ADDR") or "localhost"
        coordinator_address = f"{addr}:{_env_int('MASTER_PORT') or DEFAULT_PORT}"
    kw = {}
    if backend == "nccl":
        local = _env_int("LOCAL_RANK")
        card = torch.device("cuda", local if local is not None
                            else rank % torch.cuda.device_count())
        torch.cuda.set_device(card)
        kw["device_id"] = card
    dist.init_process_group(backend, init_method=_init_method(coordinator_address),
                            world_size=world, rank=rank, **kw)
    return True


def global_stream_count() -> int:
    """Streams the mesh carries at one frame per card: the default group's
    world size (one card per process), 1 without a group.  Unlike
    ``jax.device_count()``, which counts every device of every process, a
    process here holds one card, so a single process counts 1 however many
    cards its machine has."""
    return dist.get_world_size() if dist.is_initialized() else 1
