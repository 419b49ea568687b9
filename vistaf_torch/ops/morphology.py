"""Binary morphology as windowed max/min reductions (JAX ``ops/morphology.py``).

Footprints are OpenCV ellipse structuring elements; dilation is one
horizontal window reduction per footprint row plus a vertical shift.  max
and min are exact, so every output is bit-equal to the JAX package's,
whatever the reduction order.  The operator is an explicit flag here (the
JAX ``_hmax`` infers it from the fill value).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

_NEG = -3.0e38
_POS = 3.0e38


def ellipse_kernel(kh: int, kw: int) -> np.ndarray:
    """cv2.getStructuringElement(MORPH_ELLIPSE, (kw, kh)), bit-identical."""
    r = kh // 2
    c = kw // 2
    inv_r2 = 1.0 / (r * r) if r > 0 else 0.0
    el = np.zeros((kh, kw), dtype=bool)
    for i in range(kh):
        dy = i - r
        if abs(dy) <= r:
            dx = c if r == 0 else int(round(c * np.sqrt(max(0.0, (r * r - dy * dy) * inv_r2))))
            el[i, max(c - dx, 0):min(c + dx + 1, kw)] = True
    return el


def _row_segments(footprint: np.ndarray) -> Tuple[Tuple[int, int, int], ...]:
    """(dy, c0, c1) horizontal runs of the footprint, relative to its centre."""
    kh, kw = footprint.shape
    ay, ax = kh // 2, kw // 2
    segs = []
    for i in range(kh):
        cols = np.where(footprint[i])[0]
        if cols.size == 0:
            continue
        c0, c1 = int(cols.min()), int(cols.max())
        if not footprint[i, c0:c1 + 1].all():
            raise ValueError("footprint rows must be contiguous runs")
        segs.append((i - ay, c0 - ax, c1 - ax))
    return tuple(segs)


def _hreduce(x: torch.Tensor, c0: int, c1: int, is_max: bool) -> torch.Tensor:
    """out[..., j] = max (or min) of x[..., j + c0 .. j + c1], outside = fill."""
    w = x.shape[-1]
    lp, rp = max(0, -c0), max(0, c1)
    xp = F.pad(x, (lp, rp), value=_NEG if is_max else _POS)
    win = xp.unfold(-1, c1 - c0 + 1, 1)
    red = win.amax(dim=-1) if is_max else win.amin(dim=-1)
    s = c0 + lp
    return red[..., s:s + w]


def _vshift(x: torch.Tensor, dy: int, fill: float) -> torch.Tensor:
    """out[..., i, :] = x[..., i + dy, :], vacated rows = fill."""
    if dy == 0:
        return x
    h = x.shape[-2]
    xp = F.pad(x, (0, 0, max(-dy, 0), max(dy, 0)), value=fill)
    s = dy + max(-dy, 0)
    return xp[..., s:s + h, :]


def _morph(x: torch.Tensor, footprint: np.ndarray, is_max: bool) -> torch.Tensor:
    fill = _NEG if is_max else _POS
    red = torch.maximum if is_max else torch.minimum
    out = torch.full_like(x, fill)
    for dy, c0, c1 in _row_segments(footprint):
        out = red(out, _vshift(_hreduce(x, c0, c1, is_max), dy, fill))
    return out


def dilate(mask: torch.Tensor, footprint: np.ndarray, iterations: int = 1) -> torch.Tensor:
    """cv2.dilate of a boolean (..., H, W) mask; outside the image is ignored."""
    x = mask.to(torch.float32)
    for _ in range(iterations):
        x = _morph(x, footprint, True)
    return x > 0.5


def erode(mask: torch.Tensor, footprint: np.ndarray, iterations: int = 1) -> torch.Tensor:
    x = mask.to(torch.float32)
    for _ in range(iterations):
        x = _morph(x, footprint, False)
    return x > 0.5


def close(mask: torch.Tensor, footprint: np.ndarray, iterations: int = 1) -> torch.Tensor:
    """cv2.morphologyEx(MORPH_CLOSE): dilate^n, then erode^n."""
    return erode(dilate(mask, footprint, iterations), footprint, iterations)


def _dilate3x3(mask: torch.Tensor) -> torch.Tensor:
    x = mask.to(torch.float32)[None, None]
    return F.max_pool2d(x, 3, stride=1, padding=1)[0, 0] > 0.5


def _shift_fill(x: torch.Tensor, k: int, axis: int, fill: bool) -> torch.Tensor:
    """Bring element ``i - k`` to position ``i`` along ``axis`` (k may be
    negative), vacated slots = ``fill``."""
    n = x.shape[axis]
    pad = torch.full_like(x.narrow(axis, 0, abs(k)), fill)
    if k >= 0:
        return torch.cat([pad, x.narrow(axis, 0, n - k)], dim=axis)
    return torch.cat([x.narrow(axis, -k, n + k), pad], dim=axis)


def _sweep(s: torch.Tensor, m: torch.Tensor, axis: int, reverse: bool) -> torch.Tensor:
    """Propagate the seed ``s`` along ``axis`` through the True runs of ``m``
    in one log-depth pass: the first-order recurrence x -> (x & m) | s as a
    Kogge-Stone doubling ladder of whole-array shifts (the JAX package's
    ``_sweep``)."""
    n = s.shape[axis]
    A, B = m, s
    k = 1
    while k < n:
        kk = -k if reverse else k
        As = _shift_fill(A, kk, axis, True)
        Bs = _shift_fill(B, kk, axis, False)
        B = (Bs & A) | B
        A = As & A
        k *= 2
    return B


# the JAX package's route switch (ops/morphology.py:214); both bodies reach
# the same fixed point
_SWEEP_MIN_PX = 1_000_000


def reconstruct(seed: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Morphological reconstruction by dilation: grow ``seed`` inside the
    (H, W) ``mask`` (8-connectivity) to its fixed point, i.e. keep the
    components of ``mask`` that hold a seed pixel.  Below 1 Mpx a round is
    8 3x3 dilations; from 1 Mpx (the native-4K reliable mask) it is the four
    axis sweeps and one 3x3 dilation, as in the JAX package.  Each round ends
    with a convergence check (one host sync)."""
    s = seed & mask
    use_sweeps = mask.shape[0] * mask.shape[1] >= _SWEEP_MIN_PX
    while True:
        if use_sweeps:
            t = _sweep(s, mask, axis=1, reverse=False)
            t = _sweep(t, mask, axis=1, reverse=True)
            t = _sweep(t, mask, axis=0, reverse=False)
            t = _sweep(t, mask, axis=0, reverse=True)
            t = _dilate3x3(t) & mask
        else:
            t = s
            for _ in range(8):
                t = _dilate3x3(t) & mask
        changed = bool((t != s).any())
        s = t
        if not changed:
            return s
