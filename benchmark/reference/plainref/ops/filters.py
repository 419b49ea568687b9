"""Separable filters with OpenCV-compatible kernels and borders
(JAX ``ops/filters.py``).

Two association orders, routed as the JAX package's ``_sep_conv2d`` routes
them.  The default is the banded-matmul order ``(B_y @ x) @ B_x^T`` with
the REFLECT_101 border folded into dense band matrices; that order is part
of the force path's accuracy contract (the JAX ``config.py`` ``conv_vpu``),
and it is why the pipelines turn TF32 off: a TF32 matmul would change every
blur.  With ``vpu=True`` (the temperature deploy preset's ``conv_vpu``)
kernels of at most 63 taps whose radius is below the plane's size run as
padded shift-adds instead; longer kernels keep the matmul.
"""
from __future__ import annotations

import numpy as np
import torch

from plainref.ops.consts import DeviceConsts
from plainref.ops.padding import fold_index, pad_last2
from plainref.ops.streams import each


def gaussian_kernel1d(sigma: float, ksize: int = 0, u8: bool = False) -> np.ndarray:
    """cv2.getGaussianKernel-compatible kernel; ``ksize`` 0 derives it from
    sigma the way cv2.GaussianBlur does for (0, 0) kernels."""
    if ksize <= 0:
        ksize = int(round(sigma * (3 if u8 else 4) * 2 + 1)) | 1
    if sigma <= 0:
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    half = (ksize - 1) * 0.5
    x = np.arange(ksize, dtype=np.float64) - half
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    k /= k.sum()
    return k.astype(np.float32)


def band_matrix(n: int, k_key: tuple) -> np.ndarray:
    """Dense banded filter matrix with the REFLECT_101 border folded in:
    (B @ v)[i] = sum_t k[t] * v[fold(i - half + t)]."""
    k = np.asarray(k_key, np.float64)
    half = (len(k) - 1) // 2
    src = fold_index(n, half, half, "reflect", torch.device("cpu")).numpy()
    B = np.zeros((n, n), np.float32)
    for t, w in enumerate(k):
        B[np.arange(n), src[t:t + n]] += w
    return B


def _band(consts: DeviceConsts, n: int, k: np.ndarray) -> torch.Tensor:
    key = tuple(np.asarray(k, np.float64))
    return consts.get(("band", n, key), lambda: band_matrix(n, key))


# the JAX package's _SHIFT_ADD_MAX_TAPS (ops/filters.py:81)
SHIFT_ADD_MAX_TAPS = 63


def _shift_add_sep2d(x: torch.Tensor, ky: np.ndarray, kx: np.ndarray) -> torch.Tensor:
    """Separable conv as padded shifts, REFLECT_101 border: the row taps
    summed left to right, then the column taps top to bottom (the JAX
    ``_shift_add_sep2d``)."""
    h, w = x.shape[-2:]
    ry, rx = (len(ky) - 1) // 2, (len(kx) - 1) // 2
    xp = pad_last2(x, (rx, rx, 0, 0), "reflect")
    row = None
    for t, c in enumerate(kx):
        term = float(c) * xp[..., :, t:t + w]
        row = term if row is None else row + term
    rp = pad_last2(row, (0, 0, ry, ry), "reflect")
    out = None
    for t, c in enumerate(ky):
        term = float(c) * rp[..., t:t + h, :]
        out = term if out is None else out + term
    return out


def sep_conv2d(x: torch.Tensor, ky: np.ndarray, kx: np.ndarray,
               consts: DeviceConsts, vpu: bool = False, streams: bool = False) -> torch.Tensor:
    """Separable 2-D convolution of the trailing (H, W) planes of ``x``,
    REFLECT_101 border, float32: shift-adds when ``vpu`` and the kernels
    have at most 63 taps with radius < size, else the banded matmuls (with
    ``streams``, x's leading axis a batched forward's stream axis, one pair
    of products a stream, ``ops/streams.py``)."""
    x = x.float()
    h, w = x.shape[-2:]
    if _shift_adds(h, w, ky, kx, vpu):
        return _shift_add_sep2d(x, ky, kx)
    by, bx = _band(consts, h, ky), _band(consts, w, kx).T
    return each(lambda v: torch.matmul(torch.matmul(by, v), bx), x, streams=streams)


def _shift_adds(h: int, w: int, ky: np.ndarray, kx: np.ndarray, vpu: bool) -> bool:
    return (vpu and max(len(ky), len(kx)) <= SHIFT_ADD_MAX_TAPS
            and (len(ky) - 1) // 2 < h and (len(kx) - 1) // 2 < w)


def gaussian_blur(x: torch.Tensor, sigma: float, consts: DeviceConsts,
                  sigma_y: float = 0.0, ksize: int = 0, u8: bool = False,
                  vpu: bool = False, streams: bool = False) -> torch.Tensor:
    """cv2.GaussianBlur(x, (ksize, ksize), sigma, sigma_y) on float32,
    REFLECT_101 border; ``sigma_y`` 0 means ``sigma``; ``streams`` as in
    ``sep_conv2d``."""
    kx = gaussian_kernel1d(sigma, ksize, u8=u8)
    ky = gaussian_kernel1d(sigma_y if sigma_y > 0 else sigma, ksize, u8=u8)
    return sep_conv2d(x, ky, kx, consts, vpu=vpu, streams=streams)


def gaussian_blur_constants(shape, sigma: float, consts: DeviceConsts,
                            sigma_y: float = 0.0, vpu: bool = False) -> None:
    """Build the band matrices that ``gaussian_blur`` of a plane of
    ``shape`` (..., H, W) reads, for a caller that blurs inside a
    ``device_if`` body, which may run first in a captured forward."""
    h, w = shape[-2:]
    kx = gaussian_kernel1d(sigma)
    ky = gaussian_kernel1d(sigma_y if sigma_y > 0 else sigma)
    if not _shift_adds(h, w, ky, kx, vpu):
        _band(consts, h, ky)
        _band(consts, w, kx)


def gaussian_blur_u8_round(x: torch.Tensor, ksize: int, consts: DeviceConsts,
                           vpu: bool = False) -> torch.Tensor:
    """cv2.GaussianBlur of a uint8 image with the sigma derived from
    ``ksize``, rounded half to even and clipped to [0, 255]."""
    out = gaussian_blur(x.float(), 0.0, consts, ksize=ksize, u8=True, vpu=vpu)
    return torch.clamp(torch.round(out), 0.0, 255.0)


def box_filter(x: torch.Tensor, ksize: int, consts: DeviceConsts,
               streams: bool = False) -> torch.Tensor:
    """cv2.boxFilter(normalize=False) with REFLECT_101 border; ``streams``
    as in ``sep_conv2d``."""
    k = np.ones(ksize, np.float32)
    return sep_conv2d(x, k, k, consts, streams=streams)


def _shift_add_conv3(x: torch.Tensor, ky: np.ndarray, kx: np.ndarray) -> torch.Tensor:
    """3-tap separable conv via padded shifts, REFLECT_101 border, in the
    JAX package's term order (left + centre) + right, then rows."""
    x = x.float()
    h, w = x.shape[-2:]
    xp = pad_last2(x, (1, 1, 1, 1), "reflect")
    c = [float(v) for v in kx]
    row = (c[0] * xp[..., 1:-1, 0:w] + c[1] * xp[..., 1:-1, 1:w + 1]
           + c[2] * xp[..., 1:-1, 2:w + 2])
    rp = pad_last2(row, (0, 0, 1, 1), "reflect")
    c = [float(v) for v in ky]
    return c[0] * rp[..., 0:h, :] + c[1] * rp[..., 1:h + 1, :] + c[2] * rp[..., 2:h + 2, :]


_DERIV = np.array([-1.0, 0.0, 1.0], np.float32)
_SMOOTH = np.array([1.0, 2.0, 1.0], np.float32)


def sobel(x: torch.Tensor, dx: int, dy: int) -> torch.Tensor:
    """cv2.Sobel(x, CV_32F, dx, dy, ksize=3) for (dx, dy) = (1, 0) or
    (0, 1), REFLECT_101 border."""
    if (dx, dy) == (1, 0):
        return _shift_add_conv3(x, _SMOOTH, _DERIV)
    if (dx, dy) == (0, 1):
        return _shift_add_conv3(x, _DERIV, _SMOOTH)
    raise ValueError("sobel supports (1,0) or (0,1)")


def gradient_magnitude(x: torch.Tensor) -> torch.Tensor:
    """sqrt(Sobel_x^2 + Sobel_y^2) with cv2's 3x3 Sobel kernels."""
    gx = sobel(x, 1, 0)
    gy = sobel(x, 0, 1)
    return torch.sqrt(gx * gx + gy * gy)


def masked_gaussian_smooth(z: torch.Tensor, mask: torch.Tensor, sigma: float,
                           consts: DeviceConsts, streams: bool = False) -> torch.Tensor:
    """Normalized-convolution smoothing blur(z*m) / (blur(m) + 1e-6);
    ``streams`` as in ``sep_conv2d``."""
    if sigma <= 0:
        return z
    m = mask.float()
    z0 = torch.where(mask, z, 0.0).float()
    num = gaussian_blur(z0, sigma, consts, streams=streams)
    den = gaussian_blur(m, sigma, consts, streams=streams) + 1e-6
    return num / den


def hanning_window(h: int, w: int) -> np.ndarray:
    """cv2.createHanningWindow: sqrt(hann_row * hann_col), (h, w) float32."""
    wy = np.hanning(h) if h > 1 else np.ones(1)
    wx = np.hanning(w) if w > 1 else np.ones(1)
    return np.sqrt(wy[:, None] * wx[None, :]).astype(np.float32)


def hann_patch(hp: int, wp: int) -> np.ndarray:
    """Hann window for the FFT sideband patch."""
    wy = np.hanning(hp).astype(np.float32)
    wx = np.hanning(wp).astype(np.float32)
    return wy[:, None] * wx[None, :]
