"""K5: the whole euclidean ECC solve (``csrc/ecc_loop.cu``).

Replaces the JAX package's ``pallas/ecc_loop_kernel.py::ecc_loop_euclidean``: a
device-side while loop of Gauss-Newton iterations, each a two-pass shear
warp of [I, gx, gy, mask] (2K + 1 hat taps, zero border), the six masked
moment rows and their 21 sums, then two adjugate 3x3 solves, the ECC lambda
step and the TPU kernel's rules: stop on ``|rho - last_rho| < eps``, on
``max_iters``, on StsNoConv failure (``lam_den <= 0`` or NaN rho) and,
with ``stall_patience``, after that many iterations without a better rho,
returning the best-rho iterate.

Routing (``kernels/__init__.py``): ``fits`` copies the JAX package's
whole-solver budget; above it, or with a seed, ``ops/registration.py``
runs the per-iteration loop with K4.  The warp and moment rows are K4's
(``ecc_kernel.moment_rows``, ``csrc/ecc_common.cuh``).

On the H100 the solve runs on one CTA: each iteration is ~2 M hat taps and
four barriers, and the iterations are sequential, so the kernel is bound by
one SM's arithmetic and by barrier latency.  A later PR could split the
plane over a thread-block cluster (the moment sums across its CTAs through
distributed shared memory), keeping the loop on the device.
"""
from __future__ import annotations

import numpy as np
import torch

from vistaf_torch import kernels
from vistaf_torch.kernels.ecc_kernel import moment_rows

_f32 = np.float32
# the JAX package's whole-solver budget (pallas/ecc_loop_kernel.py:39-46):
# ~167 bytes of scoped VMEM per padded element, 90% of 16 MiB
_BYTES_PER_ELEM_LOOP = 167
_VMEM_SCOPED_LIMIT = 16 * 2 ** 20
_VMEM_MARGIN = 0.90
_MAX_ELEMS_LOOP = int(_VMEM_MARGIN * _VMEM_SCOPED_LIMIT / _BYTES_PER_ELEM_LOOP)


def fits(shape) -> bool:
    """The JAX package's ``fits_vmem_loop``: above it (or with a seed) the
    ECC takes the per-iteration loop (``ops/registration.py``)."""
    return kernels.padded_elems(shape) <= _MAX_ELEMS_LOOP


def _moments(S_cf: torch.Tensor, T: torch.Tensor, sm: torch.Tensor,
             p, K: int) -> np.ndarray:
    """(6, 6) moment matrix of the rows [m, T m, I m, G_theta, gx m, gy m]
    sampled at the warp p = (theta, tx, ty), as float32 (K4's rows, with
    the shear scalars formed on the host in float32)."""
    c, s = np.cos(p[0]), np.sin(p[0])
    r = s / c
    co = (r, c - r * (-s) - _f32(1.0), p[2] - r * p[1], c - _f32(1.0), -s, p[1], c, s)
    rows = moment_rows(S_cf, T, sm, [float(v) for v in co], K)
    return (rows @ rows.T).cpu().numpy().astype(np.float32)


def _solve3_adjugate(h00, h01, h02, h11, h12, h22, b0, b1, b2):
    A00 = h11 * h22 - h12 * h12
    A01 = h02 * h12 - h01 * h22
    A02 = h01 * h12 - h02 * h11
    A11 = h00 * h22 - h02 * h02
    A12 = h01 * h02 - h00 * h12
    A22 = h00 * h11 - h01 * h01
    det = h00 * A00 + h01 * A01 + h02 * A02
    det = _f32(1e-30) if abs(det) < _f32(1e-30) else det
    return ((A00 * b0 + A01 * b1 + A02 * b2) / det,
            (A01 * b0 + A11 * b1 + A12 * b2) / det,
            (A02 * b0 + A12 * b1 + A22 * b2) / det)


def ecc_loop_euclidean_plain(S_cf: torch.Tensor, T: torch.Tensor,
                             stride_mask: torch.Tensor, K: int = 4,
                             max_iters: int = 300, eps: float = 1e-7,
                             stall_patience: int = 0):
    """Plain version: the same loop with the scalar tail on the host in
    float32 (one device-to-host copy per iteration)."""
    z = _f32(0.0)
    p = [z, z, z]
    best = [z, z, z]
    last_rho, rho, best_rho = _f32(-2.0), _f32(-1.0), _f32(-2.0)
    it, stall, failed = 0, 0, False
    eps32 = _f32(eps)

    def going():
        go = it < max_iters and abs(rho - last_rho) >= eps32 and not failed
        return go and (stall_patience <= 0 or stall < stall_patience)

    with np.errstate(all="ignore"):
        while going():
            M = _moments(S_cf, T, stride_mask, p, K)
            n = np.maximum(M[0, 0], _f32(1.0))
            stt, si = M[0, 1], M[0, 2]
            sg = M[0, 3:6]
            corr = M[1, 2] - stt * si / n
            tnorm2 = M[1, 1] - stt * stt / n
            inorm2 = M[2, 2] - si * si / n
            Gt = [M[1, 3 + k] - (stt / n) * sg[k] for k in range(3)]
            Gi = [M[2, 3 + k] - (si / n) * sg[k] for k in range(3)]
            reg = _f32(1e-12)
            hs = (M[3, 3] + reg, M[3, 4], M[3, 5], M[4, 4] + reg, M[4, 5], M[5, 5] + reg)
            u = _solve3_adjugate(*hs, *Gt)
            v = _solve3_adjugate(*hs, *Gi)
            lam_num = inorm2 - (Gi[0] * v[0] + Gi[1] * v[1] + Gi[2] * v[2])
            lam_den = corr - (Gt[0] * v[0] + Gt[1] * v[1] + Gt[2] * v[2])
            lam = lam_num / (_f32(1e-12) if abs(lam_den) < _f32(1e-12) else lam_den)
            dp = [lam * u[k] - v[k] for k in range(3)]
            new_rho = corr / np.maximum(
                np.sqrt(np.maximum(tnorm2, z) * np.maximum(inorm2, z)), _f32(1e-12))
            now_failed = bool(lam_den <= z) or bool(np.isnan(new_rho))
            q = p if now_failed else [p[k] + dp[k] for k in range(3)]
            if new_rho > best_rho:
                best_rho, best, stall = new_rho, list(p), 0
            else:
                stall += 1
            p = q
            last_rho, rho = rho, new_rho
            it += 1
            failed = failed or now_failed
    if stall_patience > 0 and stall >= stall_patience:
        p, rho = best, best_rho
    dev = S_cf.device
    return (torch.tensor(np.asarray(p, np.float32), device=dev),
            torch.tensor(rho, dtype=torch.float32, device=dev),
            torch.tensor(it, dtype=torch.int32, device=dev),
            torch.tensor(failed, device=dev))


def ecc_loop_euclidean(S_cf: torch.Tensor, T: torch.Tensor,
                       stride_mask: torch.Tensor, K: int = 4,
                       max_iters: int = 300, eps: float = 1e-7,
                       stall_patience: int = 0):
    """Run the whole euclidean/shear ECC solve.  ``S_cf`` = (4, H, W)
    [I, gx, gy, mask01] centred like ``ecc_align``, ``T`` the centred
    template, ``stride_mask`` the 0/1 statistics grid.  Returns device
    tensors (p (3,), rho, n_iters, failed); failure handling (identity warp,
    NaN rho) stays with the caller."""
    if kernels.route(S_cf) == "cpu":
        return ecc_loop_euclidean_plain(S_cf, T, stride_mask, K, max_iters, eps,
                                        stall_patience)
    S = S_cf.to(torch.float32).contiguous()
    t = T.to(torch.float32).contiguous()
    sm = stride_mask.to(torch.float32).contiguous()
    kernels.check_cuda("ecc_loop_euclidean", S, t, sm)
    if S.shape[0] != 4 or S.shape[1:] != t.shape or sm.shape != t.shape:
        raise ValueError(f"ecc_loop_euclidean: shapes {tuple(S.shape)}, "
                         f"{tuple(t.shape)}, {tuple(sm.shape)}")
    h, w = t.shape
    mid = torch.empty_like(S)
    out = torch.empty(6, dtype=torch.float32, device=S.device)
    kernels.launch("vt_ecc_loop_euclidean", "ecc_loop_euclidean", S.device,
                   S.data_ptr(), t.data_ptr(), sm.data_ptr(), mid.data_ptr(),
                   out.data_ptr(), h, w, int(K), int(max_iters), float(eps),
                   int(stall_patience))
    return out[:3], out[3], out[4].to(torch.int32), out[5] > 0.5
