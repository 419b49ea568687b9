"""Gather-free warps: global translation and the two-pass shear warp
(JAX ``ops/warp.py``: ``translate_bilinear``, ``shear_warp_stack``,
``warp_affine_inverse_shear``)."""
from __future__ import annotations

import torch

from vistaf_torch.ops.padding import pad_last2


def hat_resample_axis(S: torch.Tensor, disp: torch.Tensor, K: int, axis: int,
                      border: str = "constant0") -> torch.Tensor:
    """1-D linear resample of the (C, H, W) stack ``S`` along ``axis`` (1 =
    rows, 2 = columns) by the per-pixel displacement ``disp`` (H, W):
    out = sum_k max(0, 1 - |disp - k|) * shift(S, k) for k in [-K, K], in
    that order.  'constant0' reads zeros beyond the edge, 'reflect' the
    symmetric (cv2 BORDER_REFLECT) reflection."""
    _, H, W = S.shape
    pad = (0, 0, K, K) if axis == 1 else (K, K, 0, 0)
    P = pad_last2(S, pad, "symmetric" if border == "reflect" else "constant")
    out = torch.zeros_like(S)
    for k in range(-K, K + 1):
        w = torch.clamp(1.0 - torch.abs(disp - k), min=0.0)
        sl = P[:, K + k:K + k + H, :] if axis == 1 else P[:, :, K + k:K + k + W]
        out = out + sl * w
    return out


def shear_coefficients(M: torch.Tensor):
    """Scalars of the two shear passes of the inverse-map warp M (2, 3):
    vertical displacement r*u + (a11 - r*a01 - 1)*v + (a12 - r*a02) with
    r = a10/a00, horizontal (a00 - 1)*u + a01*v + a02."""
    a00, a01, a02 = M[0, 0], M[0, 1], M[0, 2]
    a10, a11, a12 = M[1, 0], M[1, 1], M[1, 2]
    r = a10 / a00
    return (r, a11 - r * a01 - 1.0, a12 - r * a02), (a00 - 1.0, a01, a02)


def shear_warp_stack(S: torch.Tensor, M: torch.Tensor, K: int = 4,
                     border: str = "constant0") -> torch.Tensor:
    """Affine inverse-map warp of a channel-first (C, H, W) stack by two 1-D
    shear passes, gather-free: dst(y, x) = S(M10 x + M11 y + M12,
    M00 x + M01 y + M02), valid while every displacement stays within
    +-(K - 1) px."""
    _, H, W = S.shape
    vv = torch.arange(H, dtype=torch.float32, device=S.device)[:, None].expand(H, W)
    uu = torch.arange(W, dtype=torch.float32, device=S.device)[None, :].expand(H, W)
    (cy_u, cy_v, cy_c), (cx_u, cx_v, cx_c) = shear_coefficients(M)
    disp_y = cy_u * uu + cy_v * vv + cy_c
    A = hat_resample_axis(S, disp_y, K, axis=1, border=border)
    disp_x = cx_u * uu + cx_v * vv + cx_c
    return hat_resample_axis(A, disp_x, K, axis=2, border=border)


def warp_affine_inverse_shear(img: torch.Tensor, M: torch.Tensor,
                              K: int = 4) -> torch.Tensor:
    """Single-plane ``shear_warp_stack`` with the reflect border (small
    warps, |disp| <= K - 1)."""
    return shear_warp_stack(img.to(torch.float32)[None], M, K=K, border="reflect")[0]


def translate_bilinear(img: torch.Tensor, dx: torch.Tensor, dy: torch.Tensor,
                       max_shift: int = 96) -> torch.Tensor:
    """out(x, y) = img(x - dx, y - dy) with bilinear interpolation, as four
    shifted windows of a padded copy (cv2.warpAffine with a translation,
    INTER_LINEAR, BORDER_REFLECT, for |shift| <= max_shift).  ``dx`` and
    ``dy`` are 0-d tensors; the window offsets stay on the device."""
    h, w = img.shape
    pad = int(max_shift) + 2
    imp = pad_last2(img.to(torch.float32), (pad, pad, pad, pad), "symmetric")
    sx = -dx.to(torch.float32)
    sy = -dy.to(torch.float32)
    x0 = torch.floor(sx)
    y0 = torch.floor(sy)
    fx = sx - x0
    fy = sy - y0
    x0i = torch.clamp(x0.to(torch.int64), -max_shift, max_shift)
    y0i = torch.clamp(y0.to(torch.int64), -max_shift, max_shift)
    rows = torch.arange(h, device=img.device) + pad
    cols = torch.arange(w, device=img.device) + pad

    def window(iy, ix):
        return imp.index_select(0, rows + iy).index_select(1, cols + ix)

    a = window(y0i, x0i)
    b = window(y0i, x0i + 1)
    c = window(y0i + 1, x0i)
    d = window(y0i + 1, x0i + 1)
    top = a * (1.0 - fx) + b * fx
    bot = c * (1.0 - fx) + d * fx
    return top * (1.0 - fy) + bot * fy
