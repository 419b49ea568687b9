"""BGR -> gray, LAB and LAB chroma with OpenCV's 8-bit conventions (JAX
``ops/color.py``).  The deploy preset evaluates LAB inside the fused
temperature kernel (``kernels/temp_kernel.py``); ``bgr_to_lab_u8`` is the
unfused LAB of the parity preset, with the JAX function's own arithmetic."""
from __future__ import annotations

import numpy as np
import torch

# ITU-R BT.601 luma weights used by cv2.COLOR_BGR2GRAY.
_GRAY_W = (0.299, 0.587, 0.114)  # R, G, B

# sRGB -> XYZ (D65) matrix used by OpenCV's RGB2Lab.
_XYZ_M = (
    (0.412453, 0.357580, 0.180423),
    (0.212671, 0.715160, 0.072169),
    (0.019334, 0.119193, 0.950227),
)
# D65 white point.
_WHITE = (0.950456, 1.0, 1.088754)


def _round_f32(x: torch.Tensor) -> torch.Tensor:
    """A float64 tensor rounded to the nearest float32 value, kept in float64."""
    return x.to(torch.float32).to(torch.float64)


def bgr_to_gray(bgr: torch.Tensor) -> torch.Tensor:
    """BGR (..., H, W, 3) uint8/float -> float32 gray, rounded half to even
    like the reference's uint8 gray, with the JAX package's rounding: its
    jitted graph evaluates 0.299 r + 0.587 g + 0.114 b as XLA's CPU code
    contracts it, fma(0.114, b, fma(0.299, r, 0.587 g)).  Each product and
    sum is exact in float64 for 8-bit inputs, so rounding each step to
    float32 gives those FMAs: the gray equals JAX's on all 2^24 8-bit BGR
    values, where three float32 products and two sums differ on 1,166 (one
    level, where the sum sits on a .5 tie)."""
    b, g, r = (bgr[..., i].to(torch.float64) for i in range(3))
    wr, wg, wb = (float(np.float32(w)) for w in _GRAY_W)
    y = _round_f32(wb * b + _round_f32(wr * r + _round_f32(wg * g)))
    return torch.round(y).to(torch.float32)


def pow_f32(x: torch.Tensor, e: float) -> torch.Tensor:
    """float32 ``x ** e`` for x >= 0 as XLA's CPU ``pow`` gives it: the power
    to float32 ``e`` taken in float64 and rounded once.  For ``e`` = 1/3 this
    equals XLA's ``cbrt`` on 99.93% of the float32 values in [0.008, 1.2]
    (the rest lie within 0.002 ulp of a rounding tie), where PyTorch's
    float32 ``pow`` equals it on 98.4%."""
    return torch.pow(x.to(torch.float64), float(np.float32(e))).to(torch.float32)


def recip_f32(c: float) -> float:
    """The float32 reciprocal of float32 ``c``: XLA's algebraic simplifier
    rewrites every ``x / c`` for a constant ``c`` as ``x * recip_f32(c)``."""
    return float(np.float32(1.0) / np.float32(c))


def _srgb_inverse_gamma(c: torch.Tensor) -> torch.Tensor:
    """sRGB companding removal (c in [0, 1])."""
    return torch.where(c <= 0.04045, c * recip_f32(12.92),
                       pow_f32((c + 0.055) * recip_f32(1.055), 2.4))


def _cbrt(t: torch.Tensor) -> torch.Tensor:
    """``jnp.cbrt`` of the non-negative LAB arguments: XLA's CPU cbrt is its
    ``pow(t, float32(1/3))``."""
    return pow_f32(t, 1.0 / 3.0)


def _f_lab(t: torch.Tensor) -> torch.Tensor:
    """CIE L*a*b* forward nonlinearity."""
    return torch.where(t > 0.008856, _cbrt(t), 7.787 * t + 16.0 / 116.0)


def bgr_to_lab_u8(bgr: torch.Tensor) -> torch.Tensor:
    """BGR (..., 3) uint8/float -> float32 LAB in OpenCV's 8-bit scaling (L
    scaled to [0, 255], a and b offset by +128), rounded half to even and
    clipped to [0, 255]: the JAX ``bgr_to_lab_u8`` op for op in float32,
    each division by a constant the multiply by its reciprocal that XLA
    compiles it to (``recip_f32``) and each power as XLA's ``pow`` takes it
    (``pow_f32``).  Differs from the fused kernel's LAB, which divides by
    the white point only in X and Z and takes its cube root as
    exp(log / 3)."""
    rl, gl, bl = (_srgb_inverse_gamma(bgr[..., i].float() * recip_f32(255.0))
                  for i in (2, 1, 0))
    m, wp = _XYZ_M, _WHITE
    x, y, z = ((m[i][0] * rl + m[i][1] * gl + m[i][2] * bl) * recip_f32(wp[i])
               for i in range(3))
    fx, fy, fz = _f_lab(x), _f_lab(y), _f_lab(z)
    L = torch.where(y > 0.008856, 116.0 * _cbrt(y) - 16.0, 903.3 * y)
    lab = torch.stack([L * (255.0 / 100.0), 500.0 * (fx - fy) + 128.0,
                       200.0 * (fy - fz) + 128.0], dim=-1)
    return torch.clamp(torch.round(lab), 0.0, 255.0)


def chroma_ab(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """LAB chroma with OpenCV's +128 centering.  The square root is taken in
    float64 and rounded once, which is the correctly rounded float32 root
    that XLA and CUDA give (PyTorch's vectorized float32 root on the CPU is
    not: it differs in the last bit for ~0.5% of integers below 1.4e5)."""
    s = (a - 128.0) * (a - 128.0) + (b - 128.0) * (b - 128.0)
    return torch.sqrt(s.to(torch.float64)).to(torch.float32)
