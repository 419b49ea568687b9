"""What may not be loaded in a run: the JAX package, JAX itself, and the
scripts that reach them.  Names compare whole, by the part before the first
dot (``vistaf_torch`` is not ``vistaf_tpu``)."""
from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = ("jax", "jaxlib", "flax", "vistaf_tpu", "chip_smoke", "bench_torch")


def loaded(names: Iterable[str] = FORBIDDEN, modules: Iterable[str] = None) -> List[str]:
    """The loaded modules whose top-level name is one of ``names``."""
    bad = set(names)
    mods = list(sys.modules if modules is None else modules)
    return sorted({m for m in mods if m.split(".", 1)[0] in bad})
