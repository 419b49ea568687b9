"""Warps (JAX ``ops/warp.py``): the bilinear gather sampler with OpenCV's
border folds (``sample_bilinear``, ``sample_bilinear_stack``,
``warp_affine_inverse_map``: the parity preset's ECC sampler and its final
warp), and the gather-free ones: global translation, the two-pass shear
warp and the Paeth three-shear rotation (``translate_bilinear``,
``shear_warp_stack``, ``warp_affine_inverse_shear``, ``line_shift_frac``,
``rotate_stack_shear``), ``warp_affine_forward``, ``rotation_matrix``,
``translation_matrix`` and ``invert_affine``."""
from __future__ import annotations

import math

import numpy as np
import torch

from plainref.ops.padding import pad_last2


def _fold_symmetric(idx: torch.Tensor, n: int) -> torch.Tensor:
    """BORDER_REFLECT (symmetric) index folding: fedcba|abcdef|fedcba."""
    period = 2 * n
    m = torch.remainder(idx, period)
    return torch.where(m >= n, period - 1 - m, m)


def _fold_reflect101(idx: torch.Tensor, n: int) -> torch.Tensor:
    """BORDER_REFLECT_101 folding: gfedcb|abcdefg|fedcba."""
    if n == 1:
        return torch.zeros_like(idx)
    period = 2 * (n - 1)
    m = torch.remainder(idx, period)
    return torch.where(m >= n, period - m, m)


def _bilinear(corners, fx: torch.Tensor, fy: torch.Tensor) -> torch.Tensor:
    """Blend of the four corner samples (a b / c d), rows first."""
    a, b, c, d = corners
    top = a * (1.0 - fx) + b * fx
    bot = c * (1.0 - fx) + d * fx
    return top * (1.0 - fy) + bot * fy


def sample_bilinear(img: torch.Tensor, sy: torch.Tensor, sx: torch.Tensor,
                    border: str = "reflect") -> torch.Tensor:
    """Bilinear sample of the (H, W) plane ``img`` at float coordinates
    (sy, sx): 'reflect' folds indices symmetrically (BORDER_REFLECT),
    'reflect101' as BORDER_REFLECT_101, anything else clamps them and reads
    zeros outside [0, w - 1] x [0, h - 1] ('constant0').  Four gathers of
    the flat plane at explicit row-major indices.  A (B, H, W) stack takes
    (B, ...) coordinates, each plane sampled at its own."""
    h, w = img.shape[-2:]
    x0 = torch.floor(sx)
    y0 = torch.floor(sy)
    fx = (sx - x0).to(torch.float32)
    fy = (sy - y0).to(torch.float32)
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)
    if border == "reflect":
        fold_y, fold_x = (lambda i: _fold_symmetric(i, h)), (lambda i: _fold_symmetric(i, w))
    elif border == "reflect101":
        fold_y, fold_x = (lambda i: _fold_reflect101(i, h)), (lambda i: _fold_reflect101(i, w))
    else:
        fold_y, fold_x = (lambda i: torch.clamp(i, 0, h - 1)), (lambda i: torch.clamp(i, 0, w - 1))
    ya, yb = fold_y(y0i) * w, fold_y(y0i + 1) * w
    if img.dim() > 2:   # each plane's offset into the flat stack
        base = (torch.arange(img.shape[0], device=img.device) * (h * w)).reshape(
            -1, *([1] * (ya.dim() - 1)))
        ya, yb = ya + base, yb + base
    xa, xb = fold_x(x0i), fold_x(x0i + 1)
    flat = img.reshape(-1)
    out = _bilinear([flat.take(ya + xa), flat.take(ya + xb), flat.take(yb + xa),
                     flat.take(yb + xb)], fx, fy)
    if border not in ("reflect", "reflect101"):
        inside = (sx >= 0) & (sx <= w - 1) & (sy >= 0) & (sy <= h - 1)
        out = torch.where(inside, out, 0.0)
    return out


def sample_bilinear_stack(stack: torch.Tensor, sy: torch.Tensor, sx: torch.Tensor
                          ) -> torch.Tensor:
    """Bilinear sample of a channel-first (C, H, W) stack at float
    coordinates (sy, sx), one index computation for all C channels: indices
    clamped into the plane, zeros outside [0, w - 1] x [0, h - 1].  The JAX
    ``sample_bilinear_stack`` takes (H, W, C); this returns (C, *sy.shape).
    A (B, C, H, W) stack takes (B, ...) coordinates, each stack sampled at
    its own, and returns (B, C, ...)."""
    C, h, w = stack.shape[-3:]
    x0 = torch.floor(sx)
    y0 = torch.floor(sy)
    fx = (sx - x0).to(torch.float32)
    fy = (sy - y0).to(torch.float32)
    x0i = torch.clamp(x0.to(torch.int64), 0, w - 1)
    y0i = torch.clamp(y0.to(torch.int64), 0, h - 1)
    x1i = torch.clamp(x0i + 1, 0, w - 1)
    y1i = torch.clamp(y0i + 1, 0, h - 1)
    flat = stack.reshape(*stack.shape[:-3], C, -1)

    def take(iy, ix):
        if stack.dim() == 3:
            return flat.index_select(1, (iy * w + ix).reshape(-1)).reshape(C, *sy.shape)
        idx = (iy * w + ix).reshape(sy.shape[0], 1, -1)
        return flat.gather(-1, idx.expand(sy.shape[0], C, idx.shape[-1])).reshape(
            sy.shape[0], C, *sy.shape[1:])

    chan = (lambda t: t) if stack.dim() == 3 else (lambda t: t[:, None])
    out = _bilinear([take(y0i, x0i), take(y0i, x1i), take(y1i, x0i), take(y1i, x1i)],
                    chan(fx), chan(fy))
    inside = (sx >= 0) & (sx <= w - 1) & (sy >= 0) & (sy <= h - 1)
    return torch.where(chan(inside), out, 0.0)


def warp_affine_inverse_map(img: torch.Tensor, M: torch.Tensor,
                            border: str = "reflect") -> torch.Tensor:
    """cv2.warpAffine(img, M, INTER_LINEAR | WARP_INVERSE_MAP) of an (H, W)
    plane: dst(x, y) = src(M00 x + M01 y + M02, M10 x + M11 y + M12); a (B,
    H, W) stack with (B, 2, 3) warps, each plane by its own."""
    h, w = img.shape[-2:]
    yy = torch.arange(h, dtype=torch.float32, device=img.device)[:, None].expand(h, w)
    xx = torch.arange(w, dtype=torch.float32, device=img.device)[None, :].expand(h, w)
    M = M[..., None, None]
    sx = M[..., 0, 0, :, :] * xx + M[..., 0, 1, :, :] * yy + M[..., 0, 2, :, :]
    sy = M[..., 1, 0, :, :] * xx + M[..., 1, 1, :, :] * yy + M[..., 1, 2, :, :]
    return sample_bilinear(img.to(torch.float32), sy, sx, border=border)


def hat_resample_axis(S: torch.Tensor, disp: torch.Tensor, K: int, axis: int,
                      border: str = "constant0") -> torch.Tensor:
    """1-D linear resample of the (..., C, H, W) stack ``S`` along ``axis``
    (1 = rows, 2 = columns) by the per-pixel displacement ``disp`` (...,
    H, W): out = sum_k max(0, 1 - |disp - k|) * shift(S, k) for k in
    [-K, K], in that order.  'constant0' reads zeros beyond the edge,
    'reflect' the symmetric (cv2 BORDER_REFLECT) reflection."""
    H, W = S.shape[-2:]
    pad = (0, 0, K, K) if axis == 1 else (K, K, 0, 0)
    P = pad_last2(S, pad, "symmetric" if border == "reflect" else "constant")
    out = torch.zeros_like(S)
    for k in range(-K, K + 1):
        w = torch.clamp(1.0 - torch.abs(disp - k), min=0.0)[..., None, :, :]
        sl = P[..., K + k:K + k + H, :] if axis == 1 else P[..., :, K + k:K + k + W]
        out = out + sl * w
    return out


def shear_coefficients(M: torch.Tensor):
    """Scalars of the two shear passes of the inverse-map warp M (2, 3):
    vertical displacement r*u + (a11 - r*a01 - 1)*v + (a12 - r*a02) with
    r = a10/a00, horizontal (a00 - 1)*u + a01*v + a02; each (..., 1, 1)
    for a (..., 2, 3) stack of warps."""
    M = M[..., None, None]
    a00, a01, a02 = M[..., 0, 0, :, :], M[..., 0, 1, :, :], M[..., 0, 2, :, :]
    a10, a11, a12 = M[..., 1, 0, :, :], M[..., 1, 1, :, :], M[..., 1, 2, :, :]
    r = a10 / a00
    return (r, a11 - r * a01 - 1.0, a12 - r * a02), (a00 - 1.0, a01, a02)


def shear_warp_stack(S: torch.Tensor, M: torch.Tensor, K: int = 4,
                     border: str = "constant0") -> torch.Tensor:
    """Affine inverse-map warp of a channel-first (C, H, W) stack by two 1-D
    shear passes, gather-free: dst(y, x) = S(M10 x + M11 y + M12,
    M00 x + M01 y + M02), valid while every displacement stays within
    +-(K - 1) px.  A (..., C, H, W) stack with (..., 2, 3) warps warps each
    by its own."""
    H, W = S.shape[-2:]
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
    warps, |disp| <= K - 1); (..., H, W) planes with (..., 2, 3) warps."""
    return shear_warp_stack(img.to(torch.float32)[..., None, :, :], M, K=K,
                            border="reflect")[..., 0, :, :]


def window_rows_cols(x: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor
                     ) -> torch.Tensor:
    """x[..., rows, :][..., cols] for the (..., H, W) planes of ``x``, with
    each plane's own (..., r) rows and (..., c) columns (device indices, so
    no host read): ``index_select`` twice for one plane, gathers for a
    stack (``jax.vmap`` of a ``dynamic_slice``)."""
    if rows.dim() == 1 and cols.dim() == 1:
        return x.index_select(-2, rows).index_select(-1, cols)
    lead = x.shape[:-2]
    r = rows.reshape(*rows.shape[:-1], *([1] * (x.dim() - 1 - rows.dim())), rows.shape[-1], 1)
    x = x.gather(-2, r.expand(*lead, rows.shape[-1], x.shape[-1]))
    c = cols.reshape(*cols.shape[:-1], *([1] * (x.dim() - 1 - cols.dim())), 1, cols.shape[-1])
    return x.gather(-1, c.expand(*lead, rows.shape[-1], cols.shape[-1]))


def translate_bilinear(img: torch.Tensor, dx: torch.Tensor, dy: torch.Tensor,
                       max_shift: int = 96) -> torch.Tensor:
    """out(x, y) = img(x - dx, y - dy) with bilinear interpolation, as four
    shifted windows of a padded copy (cv2.warpAffine with a translation,
    INTER_LINEAR, BORDER_REFLECT, for |shift| <= max_shift).  ``dx`` and
    ``dy`` are 0-d tensors, or (...,) for a (..., H, W) stack; the window
    offsets stay on the device."""
    h, w = img.shape[-2:]
    pad = int(max_shift) + 2
    imp = pad_last2(img.to(torch.float32), (pad, pad, pad, pad), "symmetric")
    sx = -dx.to(torch.float32)[..., None, None]
    sy = -dy.to(torch.float32)[..., None, None]
    x0 = torch.floor(sx)
    y0 = torch.floor(sy)
    fx = sx - x0
    fy = sy - y0
    x0i = torch.clamp(x0.to(torch.int64), -max_shift, max_shift)[..., 0]
    y0i = torch.clamp(y0.to(torch.int64), -max_shift, max_shift)[..., 0]
    rows = torch.arange(h, device=img.device) + pad
    cols = torch.arange(w, device=img.device) + pad

    def window(iy, ix):
        return window_rows_cols(imp, rows + iy, cols + ix)

    a = window(y0i, x0i)
    b = window(y0i, x0i + 1)
    c = window(y0i + 1, x0i)
    d = window(y0i + 1, x0i + 1)
    top = a * (1.0 - fx) + b * fx
    bot = c * (1.0 - fx) + d * fx
    return top * (1.0 - fy) + bot * fy


def _shift_zero(x: torch.Tensor, k: int, axis: int) -> torch.Tensor:
    """out[i] = x[i - k] along ``axis`` (static k), zero fill."""
    if k == 0:
        return x
    n = x.shape[axis]
    zeros = torch.zeros_like(x.narrow(axis, 0, min(abs(k), n)))
    if k > 0:
        return torch.cat([zeros, x.narrow(axis, 0, n - k)], dim=axis)
    return torch.cat([x.narrow(axis, -k, n + k), zeros], dim=axis)


def line_shift_frac(stack: torch.Tensor, s: torch.Tensor, shift_axis: int,
                    line_axis: int, bits: int) -> torch.Tensor:
    """Per-line fractional shift, gather-free: line i (along ``line_axis``)
    moves by s[i] along ``shift_axis``, out[..., j, ...] = in[..., j - s_i,
    ...], zero border.  The fraction is a 2-tap blend over the array padded
    by one zero at the high end, then the integer part (clamped to
    +-(2^bits - 1)) is ``bits`` select passes of statically shifted copies,
    as in the JAX package."""
    assert shift_axis != line_axis
    shape = [1] * stack.dim()
    shape[line_axis] = stack.shape[line_axis]

    def bc(v):
        return v.reshape(shape)

    lim = (1 << bits) - 1
    k = torch.clamp(torch.floor(s), -lim, lim).to(torch.int32)
    f = torch.clamp(s - k.to(torch.float32), 0.0, 1.0)
    pos = k >= 0
    m = torch.abs(k)
    zero = torch.zeros_like(stack.narrow(shift_axis, 0, 1))
    xp1 = torch.cat([stack, zero], dim=shift_axis)
    x = bc(1.0 - f) * xp1 + bc(f) * _shift_zero(xp1, 1, shift_axis)
    for b in range(bits):
        bit = ((m >> b) & 1) == 1
        xp = _shift_zero(x, 1 << b, shift_axis)
        xn = _shift_zero(x, -(1 << b), shift_axis)
        x = torch.where(bc(bit & pos), xp, torch.where(bc(bit & ~pos), xn, x))
    return x.narrow(shift_axis, 0, stack.shape[shift_axis])


def _shear_bits(max_shift: float) -> int:
    return max(1, int(math.ceil(math.log2(max_shift + 2.0))))


SHEAR_MAX_DEG = 50.0   # callers fold larger rotations by quarter turns


def rotate_stack_shear(stack: torch.Tensor, angle_deg, center) -> torch.Tensor:
    """Rotation of a channel-first (C, H, W) stack about ``center`` by the
    Paeth three-shear decomposition of the inverse map, each shear a
    ``line_shift_frac``: the JAX ``rotate_stack_shear`` (which takes
    (H, W, C)), numerically the bilinear sampling through
    ``rotation_matrix(center, angle_deg)`` with a zero border.  Valid for
    |angle_deg| <= 50; ``angle_deg`` may be a 0-d device tensor."""
    ry, rx = 1, 2
    h, w = stack.shape[ry], stack.shape[rx]
    cx, cy = float(center[0]), float(center[1])
    A = torch.as_tensor(angle_deg, dtype=torch.float32, device=stack.device) \
        * float(np.float32(np.pi / 180.0))
    c_ = torch.cos(A)
    S = -torch.sin(A)
    small = torch.abs(S) < 1e-8
    a = torch.where(small, 0.0, (1.0 - c_) / torch.where(small, 1.0, S))
    b = -S
    half_y = max(cy, (h - 1) - cy)
    half_x = max(cx, (w - 1) - cx)
    bits_x = _shear_bits(math.tan(math.radians(SHEAR_MAX_DEG) / 2) * half_y)
    bits_y = _shear_bits(math.sin(math.radians(SHEAR_MAX_DEG)) * half_x)
    rows = torch.arange(h, dtype=torch.float32, device=stack.device) - cy
    cols = torch.arange(w, dtype=torch.float32, device=stack.device) - cx
    sx = -a * rows
    sy = -b * cols
    out = line_shift_frac(stack, sx, shift_axis=rx, line_axis=ry, bits=bits_x)
    out = line_shift_frac(out, sy, shift_axis=ry, line_axis=rx, bits=bits_y)
    return line_shift_frac(out, sx, shift_axis=rx, line_axis=ry, bits=bits_x)


def invert_affine(M: torch.Tensor) -> torch.Tensor:
    """The inverse of a (2, 3) affine matrix, as a (2, 3) tensor on its
    device: [A^-1, -A^-1 t] from the adjugate over the determinant."""
    A, t = M[:, :2], M[:, 2]
    det = A[0, 0] * A[1, 1] - A[0, 1] * A[1, 0]
    inv = torch.stack([torch.stack([A[1, 1], -A[0, 1]]),
                       torch.stack([-A[1, 0], A[0, 0]])]) / det
    return torch.cat([inv, (-inv @ t)[:, None]], dim=1)


def warp_affine_forward(img: torch.Tensor, M: torch.Tensor,
                        border: str = "reflect") -> torch.Tensor:
    """cv2.warpAffine without WARP_INVERSE_MAP: ``M`` maps the source to the
    destination, so the plane is sampled through its inverse."""
    return warp_affine_inverse_map(img, invert_affine(M), border=border)


def translation_matrix(dx, dy) -> torch.Tensor:
    """[[1, 0, dx], [0, 1, dy]] as a float32 (2, 3) tensor."""
    return torch.tensor([[1.0, 0.0, float(dx)], [0.0, 1.0, float(dy)]], dtype=torch.float32)


def rotation_matrix(center, angle_deg, scale: float = 1.0) -> torch.Tensor:
    """cv2.getRotationMatrix2D as a float32 (2, 3) tensor."""
    a = torch.as_tensor(angle_deg, dtype=torch.float32) * float(np.float32(np.pi / 180.0))
    alpha = scale * torch.cos(a)
    beta = scale * torch.sin(a)
    cx, cy = center
    return torch.stack([
        torch.stack([alpha, beta, (1.0 - alpha) * cx - beta * cy]),
        torch.stack([-beta, alpha, beta * cx + (1.0 - alpha) * cy]),
    ]).to(torch.float32)
