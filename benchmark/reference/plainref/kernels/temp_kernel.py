"""K8: the fused per-pixel temperature models (``csrc/temp.cu``).

Replaces the JAX package's ``pallas/temp_kernel.py::make_fused_temperature_fn``
(``fused_temperature_maps``): from the 5x5-blurred BGR crop, per pixel,
OpenCV 8-bit LAB and gray -> chroma -> the WIDE polynomial over
(L, a, b, gray) and the COLOR polynomial over (L, a, b), each with its
optional isotonic calibrator -> gating.  Outputs: the WIDE map (NaN outside
``roi_eff``), the COLOR map (NaN outside the final colour support) and that
support, ``color_support_pre & (chroma >= color_chroma_min)``.

The plain version mirrors the Pallas body, not ``TempModelWeights.predict``
(the two round differently): the cube root is exp(log(max(t, 1e-30)) * (1/3)),
every constant is a float32 rounding of the float64 value (``b * (1/255)``
is a multiply; the XYZ rows are divided by the white point after the dot),
rounding is half to even, a monomial multiplies its factors in feature order
starting from the first, terms with a zero coefficient are skipped, and the
isotonic map takes the last segment with ``pred >= x0`` (so a NaN prediction
gives ``y[0]``, unlike ``interp``).  The kernel computes the same
operations in the same order in float32, with ``--fmad=false``.

On the H100 each thread takes 4 consecutive pixels of the flattened crop
(grid-stride; vector loads and stores, the last n % 4 pixels by scalar
accesses).  The models run as node programs built here (``node_program``):
each term's monomial is one multiply from its parent's, the term without its
last factor, with the nodes that later terms reuse in shared memory; the
calibrator's segment is found by binary search when the kept x0 never
decrease (``segments_sorted``), else by the backward scan.  The scaler
constants and the programs' offsets travel in one struct passed by value;
the programs and segments sit in one small device table.  Each input byte is
read once and each output written once, 23 bytes a pixel (about 18 us at
1608x1664 on 3.35 TB/s); the kernel spends its time on arithmetic, mostly
the LAB transcendentals.
"""
from __future__ import annotations

import ctypes
import math
from typing import Tuple

import numpy as np
import torch

from plainref import kernels
from plainref.calib.temp_weights import PolyTables, TempModelWeights
from plainref.ops.color import chroma_ab

MAX_TERMS = 64          # the kernel's term limit (node_program: at most 64 slots)
MAX_FEATURES = 4        # kMaxFeatures


def _f32(v: float) -> float:
    """The float32 rounding of ``v``, as a Python float (exact in float32)."""
    return float(np.float32(v))


# the JAX kernel's constants, each rounded to float32 as its weak-typed
# Python float is
_INV255 = _f32(1.0 / 255.0)
_INV1292 = _f32(1.0 / 12.92)
_INV1055 = _f32(1.0 / 1.055)
_THIRD = _f32(1.0 / 3.0)
_XYZ = tuple(tuple(_f32(v) for v in row) for row in (
    (0.412453, 0.357580, 0.180423),
    (0.212671, 0.715160, 0.072169),
    (0.019334, 0.119193, 0.950227)))
_WX, _WZ = _f32(0.950456), _f32(1.088754)
_EPS_LAB = _f32(0.008856)
_K7787 = _f32(7.787)
_K16_116 = _f32(16.0 / 116.0)
_K9033 = _f32(903.3)
_L_SCALE = _f32(255.0 / 100.0)
_GRAY = (_f32(0.299), _f32(0.587), _f32(0.114))


def _cbrt(t: torch.Tensor) -> torch.Tensor:
    return torch.exp(torch.log(torch.clamp(t, min=1e-30)) * _THIRD)


def lab_gray(b: torch.Tensor, g: torch.Tensor, r: torch.Tensor):
    """OpenCV 8-bit (L, a, b) and gray from float BGR in [0, 255], the JAX
    kernel's ``_lab_gray``."""
    def inv_gamma(c):
        return torch.where(c <= _f32(0.04045), c * _INV1292,
                           torch.pow((c + _f32(0.055)) * _INV1055, _f32(2.4)))

    rl = inv_gamma(r * _INV255)
    gl = inv_gamma(g * _INV255)
    bl = inv_gamma(b * _INV255)
    x = (_XYZ[0][0] * rl + _XYZ[0][1] * gl + _XYZ[0][2] * bl) / _WX
    y = _XYZ[1][0] * rl + _XYZ[1][1] * gl + _XYZ[1][2] * bl
    z = (_XYZ[2][0] * rl + _XYZ[2][1] * gl + _XYZ[2][2] * bl) / _WZ

    def f(t):
        return torch.where(t > _EPS_LAB, _cbrt(t), _K7787 * t + _K16_116)

    fx, fy, fz = f(x), f(y), f(z)
    L = torch.where(y > _EPS_LAB, 116.0 * _cbrt(y) - 16.0, _K9033 * y)
    A = 500.0 * (fx - fy) + 128.0
    B = 200.0 * (fy - fz) + 128.0
    L8 = torch.clamp(torch.round(L * _L_SCALE), 0.0, 255.0)
    A8 = torch.clamp(torch.round(A), 0.0, 255.0)
    B8 = torch.clamp(torch.round(B), 0.0, 255.0)
    gray = torch.round(_GRAY[0] * r + _GRAY[1] * g + _GRAY[2] * b)
    return L8, A8, B8, gray


def poly_eval(feats, t: PolyTables) -> torch.Tensor:
    """The JAX kernel's ``_poly_eval`` over packed tables."""
    scaled = [(f - float(m)) / float(s) for f, m, s in zip(feats, t.mean, t.scale)]
    out = torch.full_like(feats[0], float(t.intercept))
    for row, c in zip(t.powers, t.coef):
        term = None
        for f, e in enumerate(row):
            for _ in range(int(e)):
                term = scaled[f] if term is None else term * scaled[f]
        out = out + float(c) if term is None else out + float(c) * term
    return out


def isotonic(pred: torch.Tensor, t: PolyTables) -> torch.Tensor:
    """The JAX kernel's ``_isotonic``: the last segment with pred >= x0
    wins, y[0] below every knot and for NaN."""
    out = torch.full_like(pred, float(t.iso_y0))
    for x0, y0, dx, dy in t.iso_seg:
        x0 = float(x0)
        seg = float(y0) + torch.clamp((pred - x0) / float(dx), 0.0, 1.0) * float(dy)
        out = torch.where(pred >= x0, seg, out)
    return out


def _predict(feats, t: PolyTables) -> torch.Tensor:
    pred = poly_eval(feats, t)
    return pred if t.iso_y0 is None else isotonic(pred, t)


def fused_temperature_maps_plain(blurred_bgr: torch.Tensor, roi_eff: torch.Tensor,
                                 color_support_pre: torch.Tensor, chroma_min: float,
                                 color: TempModelWeights, wide: TempModelWeights):
    """Plain PyTorch version of the kernel: (wide_map, color_map,
    color_support) for the (H, W, 3) float BGR crop."""
    bgr = blurred_bgr.to(torch.float32)
    L, A, B, gray = lab_gray(bgr[..., 0], bgr[..., 1], bgr[..., 2])
    chroma = chroma_ab(A, B)
    csup = color_support_pre & (chroma >= _f32(chroma_min))
    wide_pred = _predict((L, A, B, gray), wide.tables)
    color_pred = _predict((L, A, B), color.tables)
    return (torch.where(roi_eff, wide_pred, math.nan),
            torch.where(csup, color_pred, math.nan), csup)


# ---------------------------------------------------------------------------
# node program step codes (csrc/temp.cu): src | dst << 8 | feat << 16 | term << 20
_SRC_PREV, _SRC_SLOT = 1, 2
_TERM = 1 << 20


def _factors(row) -> tuple:
    """A term's factors in fold order: feature f repeated by its exponent."""
    return tuple(f for f, e in enumerate(row) for _ in range(int(e)))


def _common_prefix(a: tuple, b: tuple) -> int:
    n = 0
    while n < min(len(a), len(b)) and a[n] == b[n]:
        n += 1
    return n


def node_program(powers: np.ndarray, coef: np.ndarray) -> Tuple[np.ndarray, int]:
    """The kernel's node program of one model: (steps (N, 2) int32 of [code,
    coefficient bits], node slots).

    Each term's monomial is the left fold of its factors in feature order,
    which equals its parent's fold (the term without its last factor) times
    one factor.  Terms are taken in table order (``out`` adds them in that
    order); a term's chain starts from the deepest of its prefixes held in a
    slot (or from its first factor), and each further node is one multiply
    from the previous one, kept in registers.  A node is stored in a slot
    when a later term can start from it and has no deeper stored prefix;
    after each store the slots that are no later term's deepest stored
    prefix are freed, so at most one more slot than later terms is live
    (at most 64 for the kernel's 64 terms)."""
    terms = [_factors(row) for row in powers]
    coef = np.asarray(coef, np.float32)
    cache = {}                       # prefix -> slot
    free: list = []
    n_slots = 0
    steps = []

    def deepest(fac: tuple) -> int:
        for n in range(len(fac), 0, -1):
            if fac[:n] in cache:
                return n
        return 0

    def prune(later) -> None:
        keep = {fac[:deepest(fac)] for fac in later}
        for key in [k for k in cache if k not in keep]:
            free.append(cache.pop(key))
        free.sort(reverse=True)

    def step(src: int, dst: int, feat: int, term: bool, c=0.0) -> None:
        code = src | dst << 8 | feat << 16 | (_TERM if term else 0)
        steps.append((code, int(np.float32(c).view(np.int32))))

    for p, fac in enumerate(terms):
        later = terms[p + 1:]
        n0 = deepest(fac)
        if not fac:
            step(0, 0, 0, True, coef[p])                  # constant term
        elif n0 == len(fac):
            step(_SRC_SLOT + cache[fac], 0, 0, True, coef[p])
        else:
            src = _SRC_SLOT + cache[fac[:n0]] if n0 else 0
            for n in range(n0 + 1, len(fac) + 1):
                dst = 0
                if any(_common_prefix(fac, q) == n and deepest(q) < n for q in later):
                    slot = free.pop() if free else n_slots
                    n_slots = max(n_slots, slot + 1)
                    cache[fac[:n]] = slot
                    dst = slot + 1
                step(src, dst, fac[n - 1] + 1, n == len(fac), coef[p] if n == len(fac) else 0.0)
                if dst:
                    prune(later)
                src = _SRC_PREV
        prune(later)
    return np.asarray(steps, np.int32).reshape(-1, 2), n_slots


def segments_sorted(seg: np.ndarray) -> bool:
    """True when the kept segments' x0 never decrease (NaN-free), so the
    kernel's binary search finds the backward scan's segment."""
    x0 = np.asarray(seg, np.float32)[:, 0]
    return bool(np.all(x0[1:] >= x0[:-1]) and not np.isnan(x0).any())


class _ModelHdr(ctypes.Structure):
    """``ModelHdr`` of csrc/temp.cu, field for field."""
    _fields_ = [("mean", ctypes.c_float * MAX_FEATURES),
                ("scale", ctypes.c_float * MAX_FEATURES),
                ("intercept", ctypes.c_float),
                ("iso_y0", ctypes.c_float),
                ("n_feat", ctypes.c_int),
                ("n_steps", ctypes.c_int),
                ("steps_off", ctypes.c_int),
                ("n_seg", ctypes.c_int),
                ("seg_off", ctypes.c_int),
                ("has_iso", ctypes.c_int),
                ("seg_sorted", ctypes.c_int)]


class _TempParams(ctypes.Structure):
    _fields_ = [("wide", _ModelHdr), ("color", _ModelHdr),
                ("chroma_min", ctypes.c_float), ("n_slots", ctypes.c_int)]


def _pad16(a: np.ndarray) -> np.ndarray:
    """``a`` as int32 words, zero-padded to a multiple of 4 (16 bytes)."""
    w = np.ascontiguousarray(a).view(np.int32).ravel()
    return np.concatenate([w, np.zeros(-w.size % 4, np.int32)])


def pack_models(wide: PolyTables, color: PolyTables, chroma_min: float):
    """(params, tables, n_slots): the kernel's header struct and the int32
    device table of both models' node programs and segments."""
    parts, hdrs, n_slots, off = [], [], 0, 0
    for t, n_feat, name in ((wide, 4, "WIDE"), (color, 3, "COLOR")):
        if t.mean.size != n_feat:
            raise ValueError(f"{name} model needs {n_feat} features, has {t.mean.size}")
        if t.coef.size > MAX_TERMS:
            raise ValueError(f"{name} model has {t.coef.size} terms; the kernel "
                             f"takes at most {MAX_TERMS}")
        steps, slots = node_program(t.powers, t.coef)
        n_slots = max(n_slots, slots)
        m = _ModelHdr()
        m.mean[:n_feat] = t.mean.tolist()
        m.scale[:n_feat] = t.scale.tolist()
        m.intercept = float(t.intercept)
        m.iso_y0 = float(t.iso_y0) if t.iso_y0 is not None else 0.0
        m.n_feat, m.n_steps, m.n_seg = n_feat, steps.shape[0], t.iso_seg.shape[0]
        m.has_iso = int(t.iso_y0 is not None)
        m.seg_sorted = int(segments_sorted(t.iso_seg))
        m.steps_off = off
        parts.append(_pad16(steps))
        off += parts[-1].size
        m.seg_off = off
        parts.append(_pad16(t.iso_seg.astype(np.float32)))
        off += parts[-1].size
        hdrs.append(m)
    params = _TempParams(hdrs[0], hdrs[1], _f32(chroma_min), n_slots)
    tables = np.concatenate(parts + [np.zeros(4, np.int32)])
    return params, tables, n_slots


def op_count(wide: TempModelWeights, color: TempModelWeights, n_px: int,
             n_wide: int, n_color: int) -> int:
    """float32 operations the function needs for ``n_px`` pixels of which
    ``n_wide`` take the WIDE model and ``n_color`` the COLOR model (a
    transcendental counts as one): about 75 for LAB, gray and chroma; per
    model 2 per feature, per term its factors' multiplies plus a multiply
    and an add, and with a calibrator a binary search over its segments
    plus 5 for the interpolation."""
    def model(t: PolyTables) -> int:
        ops = 2 * t.mean.size + int(t.powers.sum()) + t.coef.size
        if t.iso_y0 is not None:
            ops += math.ceil(math.log2(t.iso_seg.shape[0] + 1)) + 5
        return ops
    return 75 * n_px + model(wide.tables) * n_wide + model(color.tables) * n_color


def _aligned(t: torch.Tensor, nbytes: int) -> torch.Tensor:
    """``t``, or a copy of it when its storage is not ``nbytes``-aligned (the
    kernel's vector accesses need it; a fresh allocation always is)."""
    return t if t.data_ptr() % nbytes == 0 else t.clone()


def make_fused_temperature_fn(chroma_min: float, color: TempModelWeights,
                              wide: TempModelWeights):
    """``fn(blurred_bgr, roi_eff, color_support_pre) -> (wide_map,
    color_map, color_support)`` with both models baked in, as the JAX
    package's ``make_fused_temperature_fn``.  A CUDA input launches K8 (the
    packed tables go to the device once per device); a CPU input runs the
    plain version."""
    params, tables, _ = pack_models(wide.tables, color.tables, chroma_min)
    tables_on = {}

    def fn(blurred_bgr: torch.Tensor, roi_eff: torch.Tensor,
           color_support_pre: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        if kernels.route(blurred_bgr) == "cpu":
            return fused_temperature_maps_plain(blurred_bgr, roi_eff, color_support_pre,
                                                chroma_min, color, wide)
        h, w = blurred_bgr.shape[:2]
        if blurred_bgr.shape != (h, w, 3) or roi_eff.shape != (h, w) \
                or color_support_pre.shape != (h, w):
            raise ValueError("fused_temperature_maps: want (H, W, 3) BGR and (H, W) "
                             f"masks, got {tuple(blurred_bgr.shape)}, "
                             f"{tuple(roi_eff.shape)}, {tuple(color_support_pre.shape)}")
        if kernels.library().vt_temp_params_size() != ctypes.sizeof(params):
            raise RuntimeError("TempParams in csrc/temp.cu and its ctypes mirror differ")
        dev = blurred_bgr.device
        bgr = _aligned(blurred_bgr.to(torch.float32).contiguous(), 16)
        roi = _aligned(roi_eff.to(torch.bool).contiguous(), 4)
        cpre = _aligned(color_support_pre.to(torch.bool).contiguous(), 4)
        kernels.check_cuda("fused_temperature_maps", bgr, roi, cpre)
        if dev not in tables_on:
            tables_on[dev] = torch.as_tensor(tables, device=dev)
        wide_map = torch.empty((h, w), dtype=torch.float32, device=dev)
        color_map = torch.empty((h, w), dtype=torch.float32, device=dev)
        csup = torch.empty((h, w), dtype=torch.bool, device=dev)
        kernels.launch("vt_fused_temperature", "fused_temperature", dev,
                       bgr.data_ptr(), roi.data_ptr(), cpre.data_ptr(),
                       wide_map.data_ptr(), color_map.data_ptr(), csup.data_ptr(),
                       h * w, ctypes.addressof(params), tables_on[dev].data_ptr())
        return wide_map, color_map, csup

    return fn


def fused_temperature_maps(blurred_bgr: torch.Tensor, roi_eff: torch.Tensor,
                           color_support_pre: torch.Tensor, chroma_min: float,
                           color: TempModelWeights, wide: TempModelWeights):
    """One-pass WIDE/COLOR maps (NaN outside their domains) and the final
    colour support: K8 on a CUDA tensor, the plain version on a CPU one."""
    return make_fused_temperature_fn(chroma_min, color, wide)(
        blurred_bgr, roi_eff, color_support_pre)
