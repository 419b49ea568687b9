"""Static matrices and grids, built once per device and held by their owner.

The JAX package bakes its static arrays (banded blur matrices, DCT and
inverse-DFT twiddles, iota grids) into the compiled graph as constants.
Here a pipeline owns one ``DeviceConsts`` and passes it to the ops that need
such arrays, so each one is built on the host and copied to the device once,
not per frame.
"""
from __future__ import annotations

from typing import Callable, Dict, Hashable

import numpy as np
import torch


class DeviceConsts:
    """Cache of constant tensors on one device, keyed by what built them."""

    def __init__(self, device):
        self.device = torch.device(device)
        self._cache: Dict[Hashable, torch.Tensor] = {}

    def get(self, key: Hashable, build: Callable[[], np.ndarray]) -> torch.Tensor:
        t = self._cache.get(key)
        if t is None:
            t = torch.as_tensor(build(), device=self.device)
            self._cache[key] = t
        return t

    def iota(self, h: int, w: int, axis: int) -> torch.Tensor:
        """(h, w) float32 grid of row (axis 0) or column (axis 1) indices."""
        def build():
            yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
            return yy if axis == 0 else xx
        return self.get(("iota", h, w, axis), build)
