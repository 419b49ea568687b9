"""Seeded scenes of the skin, made on the card in a few large calls.

Frozen, device-side copies of ``vistaf_torch/utils/synthetic.py``'s
``synthetic_pair`` (a carrier grating under an illumination falloff, a
Gaussian dent of phase in the deformed frame, sensor noise),
``synthetic_tlc_frame`` (thermochromic stripes tilted by 8 degrees, their
hue following a radial hot spot, a dozen saturated specks) and
``synthetic_deploy_temp_weights`` (the shipped temperature models' form
with seeded numbers), and of ``chip_smoke.py::compose_multimodal_frame``
(the thermochromic colour over the grating's gray), all at commit
98381829b5ef1b546fde2f6549f168989515a1b3.

One change from the originals: the grating is printed on a skin whose
albedo varies smoothly (a seeded field, correlation length a few carrier
periods and about a tenth of the circle's radius, ``texture`` of contrast),
the same field in a stream's reference and deformed frames, as a real
skin's texture is.  The bare grating has no structure along its lines, so
the phase correlation's and the ECC's y were flat on it and their solves
undetermined; the texture fixes them.  The dent's place and depth and the
hot spot's place come from the traffic's parameters.
"""
from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from plainref.calib.temp_weights import poly_powers
from plainref.ops.geometry import circle_from_3_points, circle_from_3_points_exact


def generator(seed: int, stream: int, device) -> torch.Generator:
    """The card's generator for one stream of draws from ``seed``."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + 7919 * int(stream)) % (2 ** 63))
    return g


def _grid(h: int, w: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    yy = torch.arange(h, dtype=torch.float32, device=device)[:, None].expand(h, w)
    xx = torch.arange(w, dtype=torch.float32, device=device)[None, :].expand(h, w)
    return yy, xx


def smooth_field(h: int, w: int, cell: float, gen: torch.Generator, device) -> torch.Tensor:
    """A zero-mean, unit-variance field, smooth over ``cell`` pixels: a
    normal draw on a grid of that pitch, interpolated bicubically."""
    c = max(2, int(round(cell)))
    gh, gw = h // c + 4, w // c + 4
    z = torch.randn((1, 1, gh, gw), generator=gen, device=device)
    up = F.interpolate(z, size=(gh * c, gw * c), mode="bicubic", align_corners=False)[0, 0]
    f = up[2 * c:2 * c + h, 2 * c:2 * c + w]
    return (f - f.mean()) / f.std()


def grating_frames(h: int, w: int, circle_pts, dents: Sequence[Dict], gen: torch.Generator,
                   device, period_px: float = 12.0, texture: float = 0.1) -> torch.Tensor:
    """(1 + len(dents), h, w) uint8 gray frames of one skin: its reference
    (no dent), then one deformed frame a dent (``depth_rad``, and ``at``,
    the dent's centre off the circle's centre in units of its radius).
    Each frame draws its own noise (scale 1.5)."""
    cx, cy, r = circle_from_3_points(*circle_pts)
    yy, xx = _grid(h, w, device)
    carrier = (2.0 * math.pi / period_px) * xx
    illum = 160.0 + 30.0 * torch.exp(-((xx - w / 2) ** 2 + (yy - h / 2) ** 2)
                                     / (2 * (0.8 * max(h, w)) ** 2))
    base = illum * (1.0 + texture * smooth_field(h, w, max(4 * period_px, r / 10), gen, device))
    del illum
    out = torch.empty((1 + len(dents), h, w), dtype=torch.uint8, device=device)

    def frame(k, phase):
        sig = base * (1.0 + 0.35 * torch.cos(carrier + phase))
        sig += 1.5 * torch.randn((h, w), generator=gen, device=device)
        out[k] = sig.clamp_(0, 255).to(torch.uint8)

    frame(0, 0.0)
    for k, d in enumerate(dents, start=1):
        ox, oy = d.get("at", (0.0, 0.0))
        dx, dy = cx + ox * r, cy + oy * r
        frame(k, float(d["depth_rad"]) * torch.exp(
            -((xx - dx) ** 2 + (yy - dy) ** 2) / (2 * (0.25 * r) ** 2)))
    return out


def tlc_frame(h: int, w: int, circle_pts, hot: Sequence[float], gen: torch.Generator,
              device) -> torch.Tensor:
    """(h, w, 3) uint8 BGR thermochromic stripes: a grating tilted by 8
    degrees of period max(10, w / 240) px, its dark half near-black, its
    light half coloured by a hue that follows a radial hot spot centred
    ``hot`` (units of the circle's radius) off the circle's centre; a dozen
    white specks inside the circle; illumination falloff and noise."""
    cx, cy, r = circle_from_3_points_exact(*circle_pts)
    yy, xx = _grid(h, w, device)
    theta = math.radians(8.0)
    period = max(10.0, w / 240.0)
    phase = (2.0 * math.pi / period) * (math.cos(theta) * xx + math.sin(theta) * yy)
    light = torch.clamp(0.5 + 1.5 * torch.cos(phase), 0.0, 1.0)[..., None]
    del phase
    hx, hy = cx + hot[0] * r, cy + hot[1] * r
    hue = 0.7 * torch.exp(-((xx - hx) ** 2 + (yy - hy) ** 2) / (0.6 * r) ** 2)
    ang = 2.0 * math.pi * hue
    del hue
    color = torch.stack([150.0 + 90.0 * torch.cos(ang - 4.19),
                         150.0 + 90.0 * torch.cos(ang - 2.09),
                         150.0 + 90.0 * torch.cos(ang)], dim=-1)
    del ang
    dark = 28.0
    illum = (1.0 - 0.15 * ((xx - w / 2) ** 2 + (yy - h / 2) ** 2) / max(h, w) ** 2)[..., None]
    img = (dark + light * (color - dark)) * illum
    del color, light, illum
    img += 2.0 * torch.randn(img.shape, generator=gen, device=device)
    n = 12
    rad = max(2.0, 0.004 * r)
    u = torch.rand((3, n), generator=gen, device=device, dtype=torch.float64).cpu().numpy()
    a, d = 2.0 * np.pi * u[0], 0.8 * r * np.sqrt(u[1])
    for sx, sy in zip(cx + d * np.cos(a), cy + d * np.sin(a)):
        y0, y1 = int(max(0, sy - rad - 1)), int(min(h, sy + rad + 2))
        x0, x1 = int(max(0, sx - rad - 1)), int(min(w, sx + rad + 2))
        spot = (yy[y0:y1, x0:x1] - sy) ** 2 + (xx[y0:y1, x0:x1] - sx) ** 2 <= rad * rad
        img[y0:y1, x0:x1][spot] = 255.0
    return torch.clamp(torch.round(img), 0, 255).to(torch.uint8)


def compose(gray: torch.Tensor, tlc: torch.Tensor) -> torch.Tensor:
    """A frame of a skin that carries both patterns: the thermochromic
    frame's colour (each pixel's BGR minus its gray) over the grating's
    gray, rounded and clipped to uint8."""
    t = tlc.to(torch.float32)
    lum = 0.114 * t[..., 0] + 0.587 * t[..., 1] + 0.299 * t[..., 2]
    g = gray.to(torch.float32)
    return torch.clamp(torch.round(t + (g - lum)[..., None]), 0, 255).to(torch.uint8)


def bgr(gray: torch.Tensor) -> torch.Tensor:
    """Gray uint8 frames as BGR (the grating's camera frame)."""
    return gray[..., None].expand(*gray.shape, 3).contiguous()


def temp_model_arrays(seed: int) -> Tuple[Dict, Dict]:
    """(color, wide) temperature models as keyword dicts of
    ``TempModelWeights``: WIDE degree 3 over (L, a, b, gray), 35 terms;
    COLOR degree 2 over (L, a, b), 10 terms, with an isotonic calibrator of
    64 sorted knots spanning 20 to 33 degC; coefficients drawn from
    ``seed``, shrinking with the term's degree."""
    rng = np.random.default_rng(int(seed))

    def model(name, feats, degree, mean, scale, intercept, size):
        powers = poly_powers(len(feats), degree)
        deg = powers.sum(axis=1)
        coef = rng.normal(scale=size, size=len(powers)) / (1.0 + deg) ** 2
        return dict(name=name, feature_names=feats, scaler_mean=np.asarray(mean, np.float64),
                    scaler_scale=np.asarray(scale, np.float64), powers=powers, coef=coef,
                    intercept=float(intercept), poly_degree=degree)

    wide = model("wide_model", ("L", "a", "b", "gray"), 3, [130.0, 150.0, 150.0, 110.0],
                 [60.0, 25.0, 25.0, 55.0], 26.0, 4.0)
    color = model("color_model", ("L", "a", "b"), 2, [140.0, 160.0, 150.0],
                  [50.0, 25.0, 25.0], 27.0, 6.0)
    color["iso_x"] = np.sort(rng.uniform(15.0, 40.0, 64))
    color["iso_y"] = np.sort(rng.uniform(20.0, 33.0, 64))
    return color, wide
