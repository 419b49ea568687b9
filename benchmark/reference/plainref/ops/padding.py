"""Padding of the trailing (H, W) dimensions with numpy's modes.

``jnp.pad`` modes used by the JAX package: 'symmetric' (cv2
BORDER_REFLECT, fedcba|abcdef), 'reflect' (BORDER_REFLECT_101,
fedcb|abcdef), 'edge' (here 'replicate') and 'constant' (zeros).  The
non-constant modes are index gathers, so any rank and any pad width work
(``F.pad``'s reflect wants a pad smaller than the size and a batch dim).
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def fold_index(n: int, before: int, after: int, mode: str,
               device: torch.device) -> torch.Tensor:
    """Source index of every padded position along one axis of length n."""
    idx = torch.arange(-before, n + after, device=device)
    if mode == "symmetric":
        m = torch.remainder(idx, 2 * n)
        return torch.where(m >= n, 2 * n - 1 - m, m)
    if mode == "reflect":
        if n == 1:
            return torch.zeros_like(idx)
        period = 2 * (n - 1)
        m = torch.remainder(idx, period)
        return torch.where(m >= n, period - m, m)
    if mode == "replicate":
        return torch.clamp(idx, 0, n - 1)
    raise ValueError(f"unknown pad mode: {mode}")


def pad_last2(x: torch.Tensor, pad: Tuple[int, int, int, int],
              mode: str) -> torch.Tensor:
    """Pad the last two dims by (left, right, top, bottom), ``F.pad`` order."""
    if mode == "constant":
        return F.pad(x, pad)
    left, right, top, bottom = pad
    h, w = x.shape[-2:]
    rows = fold_index(h, top, bottom, mode, x.device)
    cols = fold_index(w, left, right, mode, x.device)
    return x.index_select(-2, rows).index_select(-1, cols)
