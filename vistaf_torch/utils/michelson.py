"""Michelson contrast utilities for TLC pigment selection (the JAX package's
``utils/michelson.py``, copied).

The reference's selection notebook (``Code/michelson.ipynb``,
SURVEY.md C18): sRGB -> linear Rec.709 relative luminance, Michelson
contrast C = (Imax - Imin) / (Imax + Imin) between a pigment color and the
background (e.g. the #323233 black used on the skin).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


def srgb_to_linear(c: np.ndarray) -> np.ndarray:
    """Inverse sRGB companding on [0, 1] values."""
    c = np.asarray(c, float)
    return np.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4)


def relative_luminance(rgb: Sequence[float]) -> float:
    """Rec.709 relative luminance of an sRGB color given as 0-255 ints or
    0-1 floats."""
    rgb = np.asarray(rgb, float)
    if rgb.max() > 1.0:
        rgb = rgb / 255.0
    lin = srgb_to_linear(rgb)
    return float(0.2126 * lin[0] + 0.7152 * lin[1] + 0.0722 * lin[2])


def michelson_contrast(color_a: Sequence[float], color_b: Sequence[float]) -> float:
    """C = (Lmax - Lmin) / (Lmax + Lmin) between two colors' luminances."""
    la = relative_luminance(color_a)
    lb = relative_luminance(color_b)
    lmax, lmin = max(la, lb), min(la, lb)
    if lmax + lmin <= 0:
        return 0.0
    return (lmax - lmin) / (lmax + lmin)


def hex_to_rgb(hx: str) -> Tuple[int, int, int]:
    hx = hx.lstrip("#")
    return tuple(int(hx[i:i + 2], 16) for i in (0, 2, 4))  # type: ignore


# The skin's background black (michelson.ipynb)
SKIN_BLACK = hex_to_rgb("#323233")


def rank_pigments(colors: dict, background: Sequence[float] = SKIN_BLACK):
    """Sort candidate pigment colors by contrast against the background."""
    scored = [(name, michelson_contrast(rgb, background)) for name, rgb in colors.items()]
    return sorted(scored, key=lambda t: -t[1])
