"""ROI geometry: circles from 3 points, circular/annulus masks, apodization.

Host-side (NumPy) constructors for *static* geometry — the reference ROI is
fixed at trace time (``shape_ftp.py:41-43``, ``temperature_sensor.py:38-45``),
so masks/apodizations are baked as constants into the jitted graphs.

Reference: ``shape_ftp.py:383-414``, ``temperature_sensor.py:157-208``.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

Point = Tuple[float, float]


def circle_from_3_points_exact(p1: Point, p2: Point, p3: Point) -> Tuple[float, float, float]:
    """Exact (float) circumcircle through three points.

    Mirrors ``temperature_sensor.py:157-177`` (float variant).
    """
    (x1, y1), (x2, y2), (x3, y3) = p1, p2, p3
    A = np.array([[2 * (x2 - x1), 2 * (y2 - y1)],
                  [2 * (x3 - x1), 2 * (y3 - y1)]], dtype=float)
    b = np.array([x2 * x2 + y2 * y2 - x1 * x1 - y1 * y1,
                  x3 * x3 + y3 * y3 - x1 * x1 - y1 * y1], dtype=float)
    cx, cy = np.linalg.solve(A, b)
    r = float(np.hypot(cx - x1, cy - y1))
    return float(cx), float(cy), r


def circle_from_3_points(p1: Point, p2: Point, p3: Point) -> Tuple[int, int, int]:
    """Rounded-int circumcircle, as used by the FTP ROI (``shape_ftp.py:406-414``)."""
    cx, cy, r = circle_from_3_points_exact(p1, p2, p3)
    return int(round(cx)), int(round(cy)), int(round(r))


def circular_mask(h: int, w: int, cx: float, cy: float, r: float) -> np.ndarray:
    """Boolean disk mask (``shape_ftp.py:383-386``)."""
    Y, X = np.ogrid[:h, :w]
    return (X - cx) ** 2 + (Y - cy) ** 2 <= r ** 2


def annulus_mask(h: int, w: int,
                 inner: Tuple[float, float, float],
                 outer: Tuple[float, float, float]) -> np.ndarray:
    """Outer disk minus inner disk (``temperature_sensor.py:187-193``)."""
    cxi, cyi, ri = inner
    cxo, cyo, ro = outer
    return circular_mask(h, w, cxo, cyo, ro) & ~circular_mask(h, w, cxi, cyi, ri)


def circular_apodization(h: int, w: int, cx: float, cy: float, r: float,
                         taper_px: float) -> np.ndarray:
    """Raised-cosine taper from radius ``r - taper`` down to 0 at ``r``
    (``shape_ftp.py:389-403``)."""
    yy, xx = np.mgrid[0:h, 0:w]
    d = np.sqrt((xx - cx) ** 2 + (yy - cy) ** 2)
    apo = np.zeros((h, w), np.float32)
    r_in = max(0.0, float(r - taper_px))
    apo[d <= r_in] = 1.0
    if taper_px > 0:
        sel = (d > r_in) & (d <= r)
        t = (d[sel] - r_in) / max(1e-6, float(taper_px))
        apo[sel] = 0.5 * (1.0 + np.cos(np.pi * t))
    return apo


def roi_crop_bbox(cx: int, cy: int, r: int, H: int, W: int) -> Tuple[int, int, int, int]:
    """Crop bounding box (x1, x2, y1, y2) clipped to the image
    (``shape_ftp.py:1502-1506``)."""
    x1 = max(0, cx - r)
    x2 = min(W, cx + r)
    y1 = max(0, cy - r)
    y2 = min(H, cy + r)
    return x1, x2, y1, y2


def local_circle(cx: int, cy: int, r: int, bbox: Tuple[int, int, int, int]) -> Tuple[int, int, int]:
    """ROI circle translated into crop coordinates, radius clipped inside the
    crop (``shape_ftp.py:1515-1517``)."""
    x1, x2, y1, y2 = bbox
    h, w = y2 - y1, x2 - x1
    cxl = cx - x1
    cyl = cy - y1
    rl = int(min(r, cxl, cyl, w - 1 - cxl, h - 1 - cyl))
    return cxl, cyl, rl


def bbox_from_mask(mask: np.ndarray, pad: int = 0) -> Tuple[int, int, int, int]:
    """(y0, y1, x0, x1) bounding box of a mask, exclusive ends, padded and
    clipped (``temperature_sensor.py:195-208``)."""
    h, w = mask.shape[:2]
    ys, xs = np.where(mask)
    if ys.size == 0 or xs.size == 0:
        return 0, h, 0, w
    y0 = int(max(0, ys.min() - int(pad)))
    y1 = int(min(h, ys.max() + int(pad) + 1))
    x0 = int(max(0, xs.min() - int(pad)))
    x1 = int(min(w, xs.max() + int(pad) + 1))
    return y0, y1, x0, x1
