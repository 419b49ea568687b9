"""Distance transforms (JAX ``ops/distance.py``): the jump-flooding
Euclidean transform and the cv2 DIST_L2 3x3 chamfer metric, with the JAX
package's pass schedules, shift order and tie rules, so the outputs are
bit-equal (integer offsets, exact f32 sums and minima)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

_FAR = 1 << 20


def _shift2(a: torch.Tensor, dy: int, dx: int, fill) -> torch.Tensor:
    """out[i, j] = a[i + dy, j + dx] over the last two dims, else ``fill``."""
    h, w = a.shape[-2:]
    p = F.pad(a, (max(-dx, 0), max(dx, 0), max(-dy, 0), max(dy, 0)), value=fill)
    r0 = dy + max(-dy, 0)
    c0 = dx + max(-dx, 0)
    return p[..., r0:r0 + h, c0:c0 + w]


def _jfa_steps(h: int, w: int, max_dist: int):
    step = 1
    size = max(h, w) if max_dist <= 0 else min(max(h, w), 2 * int(max_dist))
    steps = []
    while step < size:
        step *= 2
    while step >= 1:
        steps.append(step)
        step //= 2
    steps.append(1)  # the extra k=1 pass of JFA+1
    return steps


def distance_transform_edt(mask: torch.Tensor, max_dist: int = 0) -> torch.Tensor:
    """For each True pixel of the (H, W) mask, the Euclidean distance to the
    nearest False pixel by jump flooding; 0 on False pixels, float32.
    ``max_dist`` > 0 bounds the flood schedule (exact up to max_dist).  A
    (..., H, W) stack is a transform a plane."""
    h, w = mask.shape[-2:]
    yy = torch.arange(h, device=mask.device, dtype=torch.int32)[:, None].expand(h, w)
    xx = torch.arange(w, device=mask.device, dtype=torch.int32)[None, :].expand(h, w)
    seed = ~mask
    by = torch.where(seed, yy, _FAR)
    bx = torch.where(seed, xx, _FAR)

    def dist2(ny, nx):
        dy = (yy - ny).to(torch.float32)
        dx = (xx - nx).to(torch.float32)
        return torch.where(ny >= _FAR, 3.0e38, dy * dy + dx * dx)

    bestd = dist2(by, bx)
    for k in _jfa_steps(h, w, max_dist):
        for dy in (-k, 0, k):
            for dx in (-k, 0, k):
                if dy == 0 and dx == 0:
                    continue
                cy = _shift2(by, dy, dx, _FAR)
                cx = _shift2(bx, dy, dx, _FAR)
                candd = dist2(cy, cx)
                take = candd < bestd
                by = torch.where(take, cy, by)
                bx = torch.where(take, cx, bx)
                bestd = torch.where(take, candd, bestd)
    return torch.where(mask, torch.sqrt(bestd), 0.0)


def distance_transform_chamfer3(mask: torch.Tensor, max_dist: int = 0) -> torch.Tensor:
    """cv2.distanceTransform(DIST_L2, 3): the 3x3 chamfer metric (edge 0.955,
    diagonal 1.3693) by descending power-of-2 min-plus relaxation; exact up
    to ``max_dist`` when it is > 0, farther pixels saturate.  A (..., H, W)
    stack is a transform a plane."""
    a, b = 0.955, 1.3693
    h, w = mask.shape[-2:]
    big = 3.0e8
    d = torch.where(mask, big, 0.0)
    reach = max(h, w) if not max_dist or max_dist <= 0 else min(max(h, w),
                                                                int(max_dist / a) + 2)
    s = 1
    scales = []
    while s < reach:
        scales.append(s)
        s *= 2
    for s in list(reversed(scales)) + list(reversed(scales)) + [1]:
        for dy, dx, cost in ((0, s, s * a), (0, -s, s * a), (s, 0, s * a), (-s, 0, s * a),
                             (s, s, s * b), (s, -s, s * b), (-s, s, s * b), (-s, -s, s * b)):
            d = torch.minimum(d, _shift2(d, dy, dx, big) + cost)
    return torch.where(mask, d, 0.0)


def get_distance_fn(metric: str):
    """'euclid' = jump-flooding EDT; 'chamfer3' = cv2's 3x3 chamfer."""
    if metric == "euclid":
        return distance_transform_edt
    if metric == "chamfer3":
        return distance_transform_chamfer3
    raise ValueError(f"unknown distance metric: {metric}")


def erode_by_distance(mask: torch.Tensor, margin_px: float,
                      metric: str = "euclid") -> torch.Tensor:
    """Keep the pixels deeper than ``margin_px`` inside the mask."""
    if margin_px <= 0:
        return mask
    dist = get_distance_fn(metric)(mask, max_dist=2 * int(margin_px) + 2)
    return (dist > float(margin_px)) & mask
