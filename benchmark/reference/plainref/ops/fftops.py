"""FFT helpers (JAX ``ops/fftops.py``): the 'topk' carrier search
(``dc_notch``, ``find_top_peaks``, ``choose_carrier_peak``), the carrier
cascade over the full and the half spectrum, sub-bin parabolic refinement,
the fractional phase ramp, the sparse-patch inverse DFT and the temperature
segmentation's windowed bandpass over the full shifted spectrum and over
the rfft2 half spectrum.  Peak positions stay 0-d device tensors and
windows are taken with index tensors; nothing here syncs.  The carrier
search, the refinement and the ramp take (..., H, W) stacks of spectra
(``jax.vmap`` of the JAX functions), one peak each."""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from plainref.ops.consts import DeviceConsts
from plainref.ops.streams import each


def _argmax2(x: torch.Tensor) -> torch.Tensor:
    """Flat (row-major) index of each (..., H, W) plane's first maximum."""
    return torch.argmax(x.flatten(-2), dim=-1)


def take_flat(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x.flatten(-2)[..., idx] of each (..., H, W) plane at its own (...,)
    flat index: ``torch.take`` of a plane, a gather of a stack."""
    return x.flatten(-2).gather(-1, idx[..., None])[..., 0]


def dc_notch(mag: torch.Tensor, dc_exclusion: int) -> torch.Tensor:
    """Zero the (2 dc_exclusion)^2 square around the DC bin."""
    h, w = mag.shape[-2:]
    cy, cx = h // 2, w // 2
    iy = torch.arange(h, device=mag.device)[:, None]
    ix = torch.arange(w, device=mag.device)[None, :]
    in_notch = ((iy >= cy - dc_exclusion) & (iy < cy + dc_exclusion)
                & (ix >= cx - dc_exclusion) & (ix < cx + dc_exclusion))
    return torch.where(in_notch, 0.0, mag)


def find_top_peaks(mag: torch.Tensor, dc_exclusion: int, n_peaks: int = 12):
    """The ``n_peaks`` largest bins of the DC-notched magnitude, descending:
    (xs, ys, mags).  Equal magnitudes keep the lower flat index first, as
    ``lax.top_k`` does (a stable sort; ``torch.topk`` promises no order
    among ties, and a real spectrum's mirror peaks can tie)."""
    w = mag.shape[-1]
    m = dc_notch(mag.to(torch.float32), dc_exclusion).flatten(-2)
    vals, idx = torch.sort(m, dim=-1, descending=True, stable=True)
    vals, idx = vals[..., :n_peaks], idx[..., :n_peaks]
    return idx % w, idx // w, vals


def choose_carrier_peak(xs, ys, mags, h: int, w: int,
                        force_right_half_plane: bool = True,
                        prefer_near_center_row: bool = True,
                        peak_max_dy_frac: float = 0.12) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's candidate filter over the top-k set: keep x > cx if
    any does, then |y - cy| <= frac h if any does, and take the strongest
    left (the first on ties)."""
    cy, cx = h // 2, w // 2
    keep = torch.ones_like(mags, dtype=torch.bool)
    if force_right_half_plane:
        m1 = xs > cx
        keep = torch.where(m1.any(dim=-1, keepdim=True), m1, keep)
    if prefer_near_center_row:
        m2 = keep & (torch.abs(ys - cy) <= int(peak_max_dy_frac * h))
        keep = torch.where(m2.any(dim=-1, keepdim=True), m2, keep)
    i = torch.argmax(torch.where(keep, mags, -math.inf), dim=-1, keepdim=True)
    # gathers: indexing by the 0-dim ``i`` would read it on the host
    return xs.gather(-1, i)[..., 0], ys.gather(-1, i)[..., 0]


def carrier_peak_cascade(mag: torch.Tensor, dc_exclusion: int,
                         force_right_half_plane: bool = True,
                         prefer_near_center_row: bool = True,
                         peak_max_dy_frac: float = 0.12) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-plane carrier pick as masked argmaxes: (notch & right half &
    near row), else (notch & right half), else the notched plane.  Returns
    (x, y) bins."""
    h, w = mag.shape[-2:]
    cy, cx = h // 2, w // 2
    iy = torch.arange(h, device=mag.device)[:, None]
    ix = torch.arange(w, device=mag.device)[None, :]
    notch = ~((iy >= cy - dc_exclusion) & (iy < cy + dc_exclusion)
              & (ix >= cx - dc_exclusion) & (ix < cx + dc_exclusion))
    m1 = (notch & (ix > cx)) if force_right_half_plane else notch
    m2 = (m1 & (torch.abs(iy - cy) <= int(peak_max_dy_frac * h))
          if prefer_near_center_row else m1)
    mf = mag.to(torch.float32)
    i2 = _argmax2(torch.where(m2, mf, -3.0e38))
    i1 = _argmax2(torch.where(m1, mf, -3.0e38))
    i0 = _argmax2(torch.where(notch, mf, -3.0e38))
    idx = torch.where(m2.any(), i2, torch.where(m1.any(), i1, i0))
    return idx % w, idx // w


def refine_peak_parabolic_log(mag: torch.Tensor, px: torch.Tensor, py: torch.Tensor):
    """Sub-bin parabolic refinement on the log magnitude around (px, py);
    returns float (x, y), each (...,) for a (..., H, W) stack with (...,)
    peaks."""
    h, w = mag.shape[-2:]
    lm = torch.log(mag.to(torch.float32) + 1e-12)

    def sub(fm1, f0, fp1):
        den = fm1 - 2.0 * f0 + fp1
        d = 0.5 * (fm1 - fp1) / den
        return torch.where(torch.abs(den) < 1e-12, 0.0, d)

    x = torch.clamp(px, 1, w - 2)
    y = torch.clamp(py, 1, h - 2)

    def at(yy, xx):
        # a gather: indexing by 0-dim tensors would read them on the host
        return take_flat(lm, yy * w + xx)
    dx = sub(at(y, x - 1), at(y, x), at(y, x + 1))
    dy = sub(at(y - 1, x), at(y, x), at(y + 1, x))
    interior = (px > 0) & (px < w - 1) & (py > 0) & (py < h - 1)
    fx = torch.where(interior, px.to(torch.float32) + dx, px.to(torch.float32))
    fy = torch.where(interior, py.to(torch.float32) + dy, py.to(torch.float32))
    return fx, fy


def frac_ramp(h: int, w: int, dkx: torch.Tensor, dky: torch.Tensor,
              consts: DeviceConsts, sign: float = -1.0) -> torch.Tensor:
    """exp(sign * i * 2pi * (dkx * x / w + dky * y / h)), complex64 (h, w);
    (..., h, w) for (...,) offsets."""
    yy = consts.iota(h, w, 0)
    xx = consts.iota(h, w, 1)
    dkx = torch.as_tensor(dkx)[..., None, None]
    dky = torch.as_tensor(dky)[..., None, None]
    phase = (2.0 * math.pi) * (dkx * (xx / w) + dky * (yy / h))
    return torch.polar(torch.ones_like(phase), sign * phase)


def _sparse_patch_twiddles(hf: int, wf: int, psz: int, row0: int, col0: int):
    u = np.arange(psz) + row0 - hf // 2
    v = np.arange(psz) + col0 - wf // 2
    Ey = (np.exp(2j * np.pi * np.outer(np.arange(hf), u) / hf) / hf).astype(np.complex64)
    Ex = (np.exp(2j * np.pi * np.outer(v, np.arange(wf)) / wf) / wf).astype(np.complex64)
    return Ey, Ex


def ifft2_sparse_patch(patch: torch.Tensor, hf: int, wf: int, row0: int, col0: int,
                       consts: DeviceConsts, streams: bool = False) -> torch.Tensor:
    """ifft2(ifftshift(Z)) for Z zero except ``patch`` (..., psz, psz) at
    [row0:, col0:] of the shifted spectrum, as two twiddle matmuls
    Ey @ patch @ Ex (exact by DFT linearity; with ``streams``, patch's
    leading axis a batched forward's stream axis, one pair a stream,
    ``ops/streams.py``)."""
    psz = patch.shape[-1]
    key = ("sparse_patch", hf, wf, psz, row0, col0)
    Ey = consts.get(key + ("y",), lambda: _sparse_patch_twiddles(hf, wf, psz, row0, col0)[0])
    Ex = consts.get(key + ("x",), lambda: _sparse_patch_twiddles(hf, wf, psz, row0, col0)[1])
    return each(lambda p: torch.matmul(torch.matmul(Ey, p), Ex), patch, streams=streams)


def carrier_peak_cascade_half(mag_half: torch.Tensor, dc_exclusion: int,
                              prefer_near_center_row: bool = True,
                              peak_max_dy_frac: float = 0.12
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The cascade over the row-shifted rfft2 half spectrum
    (``mag_half[r, k] == |F_shift[r, cx + k]|``, k in [0, w/2], the Nyquist
    column included, as the JAX package scans it): (notch & k >= 1 & near
    row), else (notch & k >= 1), else the notched plane.  Returns (k, row)."""
    hf, kw = mag_half.shape
    cy = hf // 2
    dc = int(dc_exclusion)
    iy = torch.arange(hf, device=mag_half.device)[:, None]
    ik = torch.arange(kw, device=mag_half.device)[None, :]
    notch = (ik < dc) & (iy >= cy - dc) & (iy < cy + dc)
    m1 = ~notch & (ik >= 1)
    m2 = (m1 & (torch.abs(iy - cy) <= int(peak_max_dy_frac * hf))
          if prefer_near_center_row else m1)
    mf = mag_half.to(torch.float32)
    i2 = torch.argmax(torch.where(m2, mf, -3.0e38))
    i1 = torch.argmax(torch.where(m1, mf, -3.0e38))
    i0 = torch.argmax(torch.where(~notch, mf, -3.0e38))
    idx = torch.where(m2.any(), i2, torch.where(m1.any(), i1, i0))
    return idx % kw, idx // kw


def _window_twiddles(n: int, psz: int, sel, rows: bool) -> np.ndarray:
    o = np.arange(n, dtype=np.float64)
    o = o[sel] if sel is not None else o
    if rows:
        return np.exp(2j * np.pi * np.outer(o, np.arange(psz)) / n).astype(np.complex64)
    return np.exp(2j * np.pi * np.outer(np.arange(psz), o) / n).astype(np.complex64)


def _bandpass_window_tail(P: torch.Tensor, sy, sx, px, py, h: int, w: int,
                          radius: float, rows, cols, consts: DeviceConsts) -> torch.Tensor:
    """Disk-mask the (psz, psz) spectrum window ``P`` (full-plane shifted
    start (sy, sx)), then Ey @ P @ Ex times the rank-1 carrier ramp."""
    psz = P.shape[0]
    ii = consts.iota(psz, psz, 0)
    jj = consts.iota(psz, psz, 1)
    dy = ii + (sy - py).to(torch.float32)
    dx = jj + (sx - px).to(torch.float32)
    P = torch.where(dy * dy + dx * dx <= float(radius) ** 2, P, 0.0)
    rkey = (rows.start, rows.stop) if rows is not None else None
    ckey = (cols.start, cols.stop) if cols is not None else None
    Ey = consts.get(("bp_twiddle", h, psz, rkey, 0),
                    lambda: _window_twiddles(h, psz, rows, True))
    Ex = consts.get(("bp_twiddle", w, psz, ckey, 1),
                    lambda: _window_twiddles(w, psz, cols, False))
    oy = consts.get(("bp_o", h, rkey), lambda: np.arange(h, dtype=np.float32)[
        rows if rows is not None else slice(None)])
    ox = consts.get(("bp_o", w, ckey), lambda: np.arange(w, dtype=np.float32)[
        cols if cols is not None else slice(None)])
    inner = torch.matmul(torch.matmul(Ey, P), Ex)
    fy = (sy - h // 2).to(torch.float32)
    fx = (sx - w // 2).to(torch.float32)
    two_pi = float(np.float32(2.0 * np.pi))
    cay = torch.polar(torch.ones_like(oy), two_pi * (oy * fy / h))
    cax = torch.polar(torch.ones_like(ox), two_pi * (ox * fx / w))
    return inner * (cay[:, None] / (h * w)) * cax[None, :]


def ifft2_bandpass_dynamic(F_shift: torch.Tensor, px: torch.Tensor, py: torch.Tensor,
                           radius: float, consts: DeviceConsts,
                           rows: slice = None, cols: slice = None) -> torch.Tensor:
    """ifft2(ifftshift(F_shift * disk((px, py), radius))) for a peak on the
    device, by two twiddle matmuls over the disk's (2 ceil(r) + 1)^2 window
    of the shifted spectrum, its start clamped into the plane as the JAX
    ``dynamic_slice`` clamps it.  ``rows``/``cols`` restrict the output to a
    static window."""
    h, w = F_shift.shape
    rr = int(np.ceil(radius))
    psz = 2 * rr + 1
    sy = torch.clamp(py - rr, 0, h - psz)
    sx = torch.clamp(px - rr, 0, w - psz)
    ar = torch.arange(psz, device=F_shift.device)
    P = F_shift.index_select(0, sy + ar).index_select(1, sx + ar)
    return _bandpass_window_tail(P, sy, sx, px, py, h, w, radius, rows, cols, consts)


def ifft2_bandpass_dynamic_half(Rr: torch.Tensor, k_i: torch.Tensor, py: torch.Tensor,
                                radius: float, consts: DeviceConsts,
                                rows: slice = None, cols: slice = None) -> torch.Tensor:
    """ifft2(ifftshift(F_shift * disk((cx + k_i, py), radius))) from the
    row-shifted rfft2 half spectrum ``Rr`` (``Rr[r, k] == F_shift[r, cx + k]``)
    by two twiddle matmuls over the disk's window; the window's negative-kx
    columns come from Hermitian symmetry, F_shift[r, cx - k] =
    conj(Rr[(h - r) % h, k]), as the JAX package builds them.  ``rows``/
    ``cols`` restrict the output to a static window."""
    h, kw = Rr.shape
    w = 2 * (kw - 1)
    cx = w // 2
    rr = int(np.ceil(radius))
    psz = 2 * rr + 1
    px = k_i + cx
    sy = torch.clamp(py - rr, 0, h - psz)
    sx = torch.clamp(px - rr, 0, w - psz)
    ar = torch.arange(psz, device=Rr.device)
    r_idx = sy + ar
    kx = (sx - cx) + ar                       # window columns as kx (>= -rr)
    pos = Rr.index_select(0, r_idx).index_select(1, torch.clamp(kx, min=0))
    neg = torch.conj(Rr.index_select(0, torch.remainder(h - r_idx, h))
                     .index_select(1, torch.clamp(-kx, min=0)))
    P = torch.where((kx >= 0)[None, :], pos, neg)
    return _bandpass_window_tail(P, sy, sx, px, py, h, w, radius, rows, cols, consts)
