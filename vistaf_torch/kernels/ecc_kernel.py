"""K4: one ECC Gauss-Newton iteration's moment matrix (``csrc/ecc_moments.cu``).

Replaces the JAX package's ``pallas/ecc_kernel.py::gn_moments_euclidean``: the
two-pass shear warp of the [I, gx, gy, mask] stack (2K + 1 hat taps, zero
border) at the warp given by its 8 shear-pass scalars
[cy_u, cy_v, cy_c, cx_u, cx_v, cx_c, cos, sin], the mask threshold, the six
moment rows [m, T m, I m, G_theta, gx m, gy m] and their (6, 6) products.
The warp and moment rows are shared with K5 (``moment_rows`` here,
``csrc/ecc_common.cuh`` on the card), as the JAX package shares
``warp_moment_rows``.

Routing (``kernels/__init__.py``): ``fits`` copies the JAX package's budget
(``ecc_kernel.py:28,35``).  The per-iteration ECC loop
(``ops/registration.py``) takes this kernel while it holds, else the plain
moments.

On the H100 one iteration is three launches: the vertical pass over
(4, H, W), the horizontal pass and moment rows with per-CTA partial sums
(a fixed partition, no atomics), and one CTA that adds the partials in CTA
order.  At the native-4K coarse grid (295 x 295) that is a few microseconds
of work: the kernel is launch- and latency-bound, and the loop around it
costs one host sync per iteration for its stopping rule.
"""
from __future__ import annotations

from typing import List

import torch

from vistaf_torch import kernels
from vistaf_torch.ops.warp import hat_resample_axis

# the JAX package's _MAX_ELEMS (pallas/ecc_kernel.py:28)
_MAX_ELEMS = 200_000


def fits(shape) -> bool:
    """The JAX package's ``fits_vmem`` (``pallas/ecc_kernel.py:35``)."""
    return kernels.padded_elems(shape) <= _MAX_ELEMS


def shear_coeffs(p: torch.Tensor) -> torch.Tensor:
    """The 8 scalars of the euclidean warp p = (theta, tx, ty), on p's
    device, in the JAX package's order (``ops/registration.py:257-264``)."""
    c, s = torch.cos(p[0]), torch.sin(p[0])
    a00, a01, a02 = c, -s, p[1]
    a10, a11, a12 = s, c, p[2]
    r = a10 / a00
    return torch.stack([r, a11 - r * a01 - 1.0, a12 - r * a02,
                        a00 - 1.0, a01, a02, c, s])


def moment_rows(S_cf: torch.Tensor, T: torch.Tensor, sm: torch.Tensor, co,
                K: int) -> torch.Tensor:
    """(6, H*W) moment rows of the warp given by its 8 scalars ``co`` (floats
    or 0-d tensors): the JAX package's ``warp_moment_rows``."""
    cy_u, cy_v, cy_c, cx_u, cx_v, cx_c, c, s = co
    H, W = T.shape
    vv = torch.arange(H, dtype=torch.float32, device=T.device)[:, None].expand(H, W)
    uu = torch.arange(W, dtype=torch.float32, device=T.device)[None, :].expand(H, W)
    mid = hat_resample_axis(S_cf, cy_u * uu + cy_v * vv + cy_c, K, axis=1)
    iw, gxw, gyw, mw = hat_resample_axis(mid, cx_u * uu + cx_v * vv + cx_c, K, axis=2)
    mf = torch.where(mw > 0.95, 1.0, 0.0) * sm
    gxm = gxw * mf
    gym = gyw * mf
    dwx = -s * uu - c * vv
    dwy = c * uu - s * vv
    rows: List[torch.Tensor] = [mf, T * mf, iw * mf, gxm * dwx + gym * dwy, gxm, gym]
    return torch.stack(rows).reshape(6, -1)


def gn_moments_euclidean_plain(S_cf: torch.Tensor, T: torch.Tensor, sm: torch.Tensor,
                               coeffs: torch.Tensor, K: int = 4) -> torch.Tensor:
    """Plain PyTorch version of K4: the (6, 6) moment matrix."""
    rows = moment_rows(S_cf, T, sm, [coeffs[i] for i in range(8)], K)
    return rows @ rows.T


def gn_moments_euclidean(S_cf: torch.Tensor, T: torch.Tensor, sm: torch.Tensor,
                         coeffs: torch.Tensor, K: int = 4) -> torch.Tensor:
    """(6, 6) ECC moment matrix for the centred stack ``S_cf`` = (4, H, W)
    [I, gx, gy, mask01], the centred template ``T``, the 0/1 statistics grid
    ``sm`` and the warp's 8 shear scalars ``coeffs`` (``shear_coeffs``)."""
    if kernels.route(S_cf) == "cpu":
        return gn_moments_euclidean_plain(S_cf, T, sm, coeffs, K)
    S = S_cf.to(torch.float32).contiguous()
    t = T.to(torch.float32).contiguous()
    m = sm.to(torch.float32).contiguous()
    co = coeffs.to(torch.float32).contiguous()
    kernels.check_cuda("gn_moments_euclidean", S, t, m, co)
    if S.shape[0] != 4 or S.shape[1:] != t.shape or m.shape != t.shape or co.shape != (8,):
        raise ValueError(f"gn_moments_euclidean: shapes {tuple(S.shape)}, "
                         f"{tuple(t.shape)}, {tuple(m.shape)}, {tuple(co.shape)}")
    h, w = t.shape
    nblk = kernels.library().vt_gn_moments_blocks(h, w)
    mid = torch.empty_like(S)
    partials = torch.empty((nblk, 21), dtype=torch.float32, device=S.device)
    out = torch.empty((6, 6), dtype=torch.float32, device=S.device)
    kernels.launch("vt_gn_moments_euclidean", "gn_moments_euclidean", S.device,
                   S.data_ptr(), t.data_ptr(), m.data_ptr(), co.data_ptr(), mid.data_ptr(),
                   partials.data_ptr(), out.data_ptr(), h, w, int(K))
    return out
