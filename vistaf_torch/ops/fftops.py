"""FFT helpers of the demodulation (JAX ``ops/fftops.py``): the carrier
cascade, sub-bin parabolic refinement, the fractional phase ramp and the
sparse-patch inverse DFT.  ``find_top_peaks``/``choose_carrier_peak`` (the
'topk' search) and the temperature path's bandpass helpers are not ported
yet.  Peak positions stay 0-d device tensors; nothing here syncs."""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from vistaf_torch.ops.consts import DeviceConsts


def carrier_peak_cascade(mag: torch.Tensor, dc_exclusion: int,
                         force_right_half_plane: bool = True,
                         prefer_near_center_row: bool = True,
                         peak_max_dy_frac: float = 0.12) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-plane carrier pick as masked argmaxes: (notch & right half &
    near row), else (notch & right half), else the notched plane.  Returns
    (x, y) bins."""
    h, w = mag.shape
    cy, cx = h // 2, w // 2
    iy = torch.arange(h, device=mag.device)[:, None]
    ix = torch.arange(w, device=mag.device)[None, :]
    notch = ~((iy >= cy - dc_exclusion) & (iy < cy + dc_exclusion)
              & (ix >= cx - dc_exclusion) & (ix < cx + dc_exclusion))
    m1 = (notch & (ix > cx)) if force_right_half_plane else notch
    m2 = (m1 & (torch.abs(iy - cy) <= int(peak_max_dy_frac * h))
          if prefer_near_center_row else m1)
    mf = mag.to(torch.float32)
    i2 = torch.argmax(torch.where(m2, mf, -3.0e38))
    i1 = torch.argmax(torch.where(m1, mf, -3.0e38))
    i0 = torch.argmax(torch.where(notch, mf, -3.0e38))
    idx = torch.where(m2.any(), i2, torch.where(m1.any(), i1, i0))
    return idx % w, idx // w


def refine_peak_parabolic_log(mag: torch.Tensor, px: torch.Tensor, py: torch.Tensor):
    """Sub-bin parabolic refinement on the log magnitude around (px, py);
    returns float (x, y)."""
    h, w = mag.shape
    lm = torch.log(mag.to(torch.float32) + 1e-12)

    def sub(fm1, f0, fp1):
        den = fm1 - 2.0 * f0 + fp1
        d = 0.5 * (fm1 - fp1) / den
        return torch.where(torch.abs(den) < 1e-12, 0.0, d)

    x = torch.clamp(px, 1, w - 2)
    y = torch.clamp(py, 1, h - 2)
    dx = sub(lm[y, x - 1], lm[y, x], lm[y, x + 1])
    dy = sub(lm[y - 1, x], lm[y, x], lm[y + 1, x])
    interior = (px > 0) & (px < w - 1) & (py > 0) & (py < h - 1)
    fx = torch.where(interior, px.to(torch.float32) + dx, px.to(torch.float32))
    fy = torch.where(interior, py.to(torch.float32) + dy, py.to(torch.float32))
    return fx, fy


def frac_ramp(h: int, w: int, dkx: torch.Tensor, dky: torch.Tensor,
              consts: DeviceConsts, sign: float = -1.0) -> torch.Tensor:
    """exp(sign * i * 2pi * (dkx * x / w + dky * y / h)), complex64 (h, w)."""
    yy = consts.iota(h, w, 0)
    xx = consts.iota(h, w, 1)
    phase = (2.0 * math.pi) * (dkx * (xx / w) + dky * (yy / h))
    return torch.polar(torch.ones_like(phase), sign * phase)


def _sparse_patch_twiddles(hf: int, wf: int, psz: int, row0: int, col0: int):
    u = np.arange(psz) + row0 - hf // 2
    v = np.arange(psz) + col0 - wf // 2
    Ey = (np.exp(2j * np.pi * np.outer(np.arange(hf), u) / hf) / hf).astype(np.complex64)
    Ex = (np.exp(2j * np.pi * np.outer(v, np.arange(wf)) / wf) / wf).astype(np.complex64)
    return Ey, Ex


def ifft2_sparse_patch(patch: torch.Tensor, hf: int, wf: int, row0: int, col0: int,
                       consts: DeviceConsts) -> torch.Tensor:
    """ifft2(ifftshift(Z)) for Z zero except ``patch`` (..., psz, psz) at
    [row0:, col0:] of the shifted spectrum, as two twiddle matmuls
    Ey @ patch @ Ex (exact by DFT linearity)."""
    psz = patch.shape[-1]
    key = ("sparse_patch", hf, wf, psz, row0, col0)
    Ey = consts.get(key + ("y",), lambda: _sparse_patch_twiddles(hf, wf, psz, row0, col0)[0])
    Ex = consts.get(key + ("x",), lambda: _sparse_patch_twiddles(hf, wf, psz, row0, col0)[1])
    return torch.matmul(torch.matmul(Ey, patch), Ex)
