"""K4: the per-iteration ECC Gauss-Newton loop (``csrc/ecc_gn_loop.cu``).

Replaces the JAX package's ``pallas/ecc_kernel.py::gn_moments_euclidean`` with the
``jax.lax.while_loop`` that calls it once an iteration
(``ops/registration.py:281-331``): each iteration the two-pass shear warp
of the [I, gx, gy, mask] stack (2K + 1 hat taps, zero border) at the warp
given by its 8 shear-pass scalars [cy_u, cy_v, cy_c, cx_u, cx_v, cx_c, cos,
sin], the mask threshold, the six moment rows [m, T m, I m, G_theta, gx m,
gy m] and their (6, 6) products, then ``linalg.solve`` of H + 1e-12 I for
both right-hand sides, the lambda step, cv2's StsNoConv failure rule, the
eps test and ``stall_patience`` with the best-rho iterate.  The warp and
moment rows are shared with K5 (``moment_rows`` here,
``csrc/ecc_common.cuh`` on the card), as the JAX package shares
``warp_moment_rows``.

Routing (``kernels/__init__.py``): ``fits`` copies the JAX package's budget
(``ecc_kernel.py:28,35``).  ``ops/registration.py`` takes
``gn_loop_euclidean`` for a euclidean shear-sampler solve that is seeded or
has ``loop_kernel=False`` while ``fits`` holds; above it, and for every
other motion type or sampler, the same loop (``gn_loop``) with the plain
moments, as the JAX package takes plain XLA there.

On the H100 a solve is one cooperative launch with the loop on the card: one
CTA per tile of an nr x nc tiling (``tile_plan``, at most one CTA per SM),
each holding its tile's inputs, copied once with bulk asynchronous copies,
and its vertically sheared rows in shared memory; the 21 sums meet once an
iteration through global memory and one grid barrier, and every thread
takes the same Gauss-Newton step (LU with partial pivoting, LAPACK's order)
on the same bits.  ``gn_moments_euclidean`` is the same kernel run for one
iteration from given shear scalars, writing the summed matrix.
``LAUNCHES["gn_moments_euclidean"]`` counts one per solve or matrix.  A
shape above ``fits`` raises ``ValueError`` before any launch.

A stack of B solves (``jax.vmap`` of the JAX loop, K4 vmapped inside it) is
one cooperative launch counted once: as many solves' tilings as are resident
at once, the stack in waves of that many, each solve with its own sums, step
and stop, frozen once it stops.  A solve's tiling depends on its shape only
(``tile_plan`` against the SM count, never B), so each solve of a stack is
bit for bit its single launch.  The plain version of a stack is ``gn_loop``
over the stacked plain moments, the loop running while any solve is live.
"""
from __future__ import annotations

import functools
from typing import Callable, List

import torch

from vistaf_torch import kernels
from vistaf_torch.ops.streams import each, keep_live
from vistaf_torch.ops.warp import hat_resample_axis
from vistaf_torch.utils.cuda_graph import device_while

# the JAX package's _MAX_ELEMS (pallas/ecc_kernel.py:28)
_MAX_ELEMS = 200_000
# kThreads and kMaxSmem in csrc/ecc_gn_loop.cu
THREADS = 512
MAX_SMEM_BYTES = 232448 - 8192
MOMENTS = 21


def fits(shape) -> bool:
    """The JAX package's ``fits_vmem`` (``pallas/ecc_kernel.py:35``)."""
    return kernels.padded_elems(shape) <= _MAX_ELEMS


def shear_coeffs(p: torch.Tensor) -> torch.Tensor:
    """The 8 scalars of the euclidean warp p = (theta, tx, ty), on p's
    device, in the JAX package's order (``ops/registration.py:257-264``);
    (..., 8) for a (..., 3) stack of warps."""
    c, s = torch.cos(p[..., 0]), torch.sin(p[..., 0])
    a00, a01, a02 = c, -s, p[..., 1]
    a10, a11, a12 = s, c, p[..., 2]
    r = a10 / a00
    return torch.stack([r, a11 - r * a01 - 1.0, a12 - r * a02,
                        a00 - 1.0, a01, a02, c, s], dim=-1)


def moment_rows(S_cf: torch.Tensor, T: torch.Tensor, sm: torch.Tensor, co,
                K: int) -> torch.Tensor:
    """(6, H*W) moment rows of the warp given by its 8 scalars ``co`` (floats
    or 0-d tensors): the JAX package's ``warp_moment_rows``.  A (..., 4, H,
    W) stack with (..., H, W) templates and (...,) scalars gives (..., 6,
    H*W)."""
    cy_u, cy_v, cy_c, cx_u, cx_v, cx_c, c, s = (
        x[..., None, None] if isinstance(x, torch.Tensor) else x for x in co)
    H, W = T.shape[-2:]
    vv = torch.arange(H, dtype=torch.float32, device=T.device)[:, None].expand(H, W)
    uu = torch.arange(W, dtype=torch.float32, device=T.device)[None, :].expand(H, W)
    mid = hat_resample_axis(S_cf, cy_u * uu + cy_v * vv + cy_c, K, axis=1)
    iw, gxw, gyw, mw = hat_resample_axis(mid, cx_u * uu + cx_v * vv + cx_c, K,
                                         axis=2).unbind(-3)
    mf = torch.where(mw > 0.95, 1.0, 0.0) * sm
    gxm = gxw * mf
    gym = gyw * mf
    dwx = -s * uu - c * vv
    dwy = c * uu - s * vv
    rows: List[torch.Tensor] = [mf, T * mf, iw * mf, gxm * dwx + gym * dwy, gxm, gym]
    return torch.stack(rows, dim=-3).reshape(*T.shape[:-2], 6, -1)


def gn_moments_euclidean_plain(S_cf: torch.Tensor, T: torch.Tensor, sm: torch.Tensor,
                               coeffs: torch.Tensor, K: int = 4) -> torch.Tensor:
    """Plain PyTorch version of one iteration's (6, 6) moment matrix;
    (..., 6, 6) for stacks, the product once a plane (``ops/streams.py``)."""
    rows = moment_rows(S_cf, T, sm, coeffs.unbind(-1), K)
    return each(lambda r: r @ r.T, rows, streams=rows.dim() > 2)


def gn_loop(moments: Callable[[torch.Tensor], torch.Tensor], p0: torch.Tensor,
            max_iters: int, eps: float, stall_patience: int,
            dtype: torch.dtype = torch.float32):
    """The Gauss-Newton ``lax.while_loop`` of the JAX ``ecc_align``
    (``vistaf_tpu/ops/registration.py:300-335``) as a ``device_while``,
    ``moments(p)`` giving each iteration's (3 + P, 3 + P) matrix, in
    ``dtype``, for the P warp parameters of ``p0``: ``linalg.solve`` of H +
    1e-12 I for both right-hand sides, the lambda step, cv2's StsNoConv
    failure rule and, with ``stall_patience``, the best-rho iterate on a
    stall.  The step and rho are computed in ``dtype``, the warp parameters
    stay in ``p0``'s.  The state (p, last rho, rho, the int32 trip count,
    failed, best rho, best p, stall) is made by fills and updated in place;
    under a capture the loop is a WHILE node, elsewhere its condition is
    read on the host once a trip.  Returns (p, rho, n_iters, failed) as
    tensors.

    A (B, P) ``p0`` is B solves, ``jax.vmap`` of the loop: ``moments``
    gives (B, 3 + P, 3 + P), each solve has its own stop, the loop runs
    while any solve is live and a trip writes only the live solves' state,
    so a solve that has stopped stays as it stopped.  The solve and the
    dot products run once a solve (``ops/streams.py``), so each solve has
    its own loop's bits."""
    dev = p0.device
    lead = p0.shape[:-1]
    batched = len(lead) > 0
    eye = 1e-12 * torch.eye(p0.shape[-1], dtype=torch.float32, device=dev)
    state = (p0.clone(), torch.full(lead, -2.0, dtype=dtype, device=dev),
             torch.full(lead, -1.0, dtype=dtype, device=dev),
             torch.zeros(lead, dtype=torch.int32, device=dev),
             torch.zeros(lead, dtype=torch.bool, device=dev),
             torch.full(lead, -2.0, dtype=dtype, device=dev), p0.clone(),
             torch.zeros(lead, dtype=torch.int32, device=dev))

    def live(s):
        p, last_rho, rho, it, failed, best_rho, best_p, stall = s
        go = (it < max_iters) & (torch.abs(rho - last_rho) >= eps) & ~failed
        if stall_patience > 0:
            go = go & (stall < stall_patience)
        return go

    def cond(s):
        return live(s).any() if batched else live(s)

    def body(s):
        p, last_rho, rho, it, failed, best_rho, best_p, stall = s
        M = moments(p)
        n = torch.clamp(M[..., 0, 0], min=1.0)
        st, si = M[..., 0, 1], M[..., 0, 2]
        sg = M[..., 0, 3:]
        corr = M[..., 1, 2] - st * si / n
        tnorm2 = M[..., 1, 1] - st * st / n
        inorm2 = M[..., 2, 2] - si * si / n
        Gt = M[..., 1, 3:] - (st / n)[..., None] * sg
        Gi = M[..., 2, 3:] - (si / n)[..., None] * sg
        UV = each(lambda a, b: torch.linalg.solve_ex(a, b)[0], M[..., 3:, 3:] + eye,
                  torch.stack([Gt, Gi], dim=-1), streams=batched)
        u, v1 = UV[..., 0], UV[..., 1]
        lam_num = inorm2 - each(torch.dot, Gi, v1, streams=batched)
        lam_den = corr - each(torch.dot, Gt, v1, streams=batched)
        lam = lam_num / torch.where(torch.abs(lam_den) < 1e-12, 1e-12, lam_den)
        p_new = p + (lam[..., None] * u - v1).to(p.dtype)
        new_rho = corr / torch.clamp(torch.sqrt(torch.clamp(tnorm2, min=0.0)
                                                * torch.clamp(inorm2, min=0.0)), min=1e-12)
        now_failed = (lam_den <= 0.0) | torch.isnan(new_rho)
        p_new = torch.where(now_failed[..., None], p, p_new)
        improved = new_rho > best_rho
        best_rho_new = torch.where(improved, new_rho, best_rho)
        best_p_new = torch.where(improved[..., None], p, best_p)
        stall_new = torch.where(improved, 0, stall + 1)
        go = live(s) if batched else None

        def keep(new, old):   # only the live solves move
            return new if go is None else keep_live(go, new, old)
        # in place, once every read of the old state is done
        best_rho.copy_(keep(best_rho_new, best_rho))
        best_p.copy_(keep(best_p_new, best_p))
        stall.copy_(keep(stall_new, stall))
        last_rho.copy_(keep(rho, last_rho))
        rho.copy_(keep(new_rho, rho))
        p.copy_(keep(p_new, p))
        failed.logical_or_(now_failed if go is None else now_failed & go)
        it.add_(1 if go is None else go.to(torch.int32))

    device_while(cond, body, state, site="ecc")
    p, _, rho, it, failed, best_rho, best_p, stall = state
    if stall_patience > 0:
        stalled = stall >= stall_patience
        p = torch.where(stalled[..., None], best_p, p)
        rho = torch.where(stalled, best_rho, rho)
    return p, rho, it, failed


def gn_loop_euclidean_plain(S_cf: torch.Tensor, T: torch.Tensor, sm: torch.Tensor,
                            p0: torch.Tensor, K: int = 4, max_iters: int = 300,
                            eps: float = 1e-7, stall_patience: int = 0):
    """Plain version of K4: ``gn_loop`` over the plain moments; a (B, 4, H,
    W) stack with (B, H, W) templates and (B, 3) seeds is B solves."""
    return gn_loop(lambda q: gn_moments_euclidean_plain(S_cf, T, sm, shear_coeffs(q), K),
                   p0.to(torch.float32).reshape(*T.shape[:-2], 3), max_iters, eps,
                   stall_patience)


def tile_bytes(h: int, w: int, K: int, nr: int, nc: int) -> int:
    """Dynamic shared memory of the nr x nc tiling of an (h, w) plane: the
    largest tile's ``mid`` (float4), its window of the four planes and its
    template and statistics rows, each row padded to start at its global
    address' 16-byte phase (``Layout`` in ``csrc/ecc_gn_loop.cu``)."""
    rh, cw = -(-h // nr), -(-w // nc)
    wr, wc = min(h, rh + 2 * K), min(w, cw + 2 * K)
    ld_s, ld_t = (wc + 6) // 4 * 4, (cw + 6) // 4 * 4
    return 4 * (4 * rh * wc + 4 * wr * ld_s + 2 * rh * ld_t)


@functools.lru_cache(maxsize=64)
def tile_plan(h: int, w: int, K: int, ctas: int):
    """(nr, nc): the tiling of an (h, w) plane over at most ``ctas`` CTAs of
    ``THREADS`` threads whose largest tile fits ``MAX_SMEM_BYTES`` and needs
    the fewest thread rounds of hat taps (vertical pass over the tile's rows
    and window columns, horizontal pass and moment rows over its pixels);
    then the fewest CTAs (a cheaper exchange), then the least memory."""
    taps = 2 * K + 1
    best = None
    for nc in range(1, min(w, ctas) + 1):
        for nr in range(1, min(h, ctas // nc) + 1):
            nbytes = tile_bytes(h, w, K, nr, nc)
            if nbytes > MAX_SMEM_BYTES:
                continue
            rh, cw = -(-h // nr), -(-w // nc)
            wc = min(w, cw + 2 * K)
            cost = (-(-rh * wc // THREADS) * 4 * taps
                    + -(-rh * cw // THREADS) * (4 * taps + 30))
            key = (cost, nr * nc, nbytes)
            if best is None or key < best[0]:
                best = (key, nr, nc)
    if best is None:
        raise ValueError(f"gn_loop_euclidean: no tiling of {h}x{w} (K = {K}) fits a CTA's "
                         "shared memory")
    return best[1], best[2]


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _launch(name: str, S_cf: torch.Tensor, T: torch.Tensor, sm: torch.Tensor, K: int,
            p0=None, coeffs=None, max_iters: int = 0, eps: float = 0.0,
            stall_patience: int = 0) -> torch.Tensor:
    """One launch of the K4 kernel: the loop from ``p0``, or one iteration
    at ``coeffs``; for a (B, 4, H, W) stack with (B, H, W) templates and
    (B, 3) seeds, the B loops.  Returns its output vector (6 or 36 floats),
    (B, 6) for a stack."""
    S = S_cf.to(torch.float32).contiguous()
    t = T.to(torch.float32).contiguous()
    seed = (p0 if coeffs is None else coeffs).to(torch.float32).contiguous()
    lead = t.shape[:-2]
    m = sm.to(torch.float32).expand(t.shape).contiguous()
    kernels.check_cuda(name, S, t, m, seed)
    if len(lead) > 1 or (lead and coeffs is not None) or S.shape != (*lead, 4, *t.shape[-2:]) \
            or seed.shape != ((*lead, 3) if coeffs is None else (8,)):
        raise ValueError(f"{name}: shapes {tuple(S.shape)}, {tuple(t.shape)}, "
                         f"{tuple(sm.shape)}, {tuple(seed.shape)}")
    h, w = t.shape[-2:]
    if not fits((h, w)):
        raise ValueError(f"{name}: {h}x{w} is above K4's budget (ecc_kernel.fits)")
    nr, nc = tile_plan(h, w, int(K), _sm_count(S.device.index or 0))
    if lead:
        n = lead[0]
        with torch.cuda.device(S.device):
            slots = kernels.library().vt_gn_loop_stack_slots(n, h, w, int(K), nr, nc)
        if slots < 1:
            raise RuntimeError(f"{name}: CUDA error {-slots}")
        work = torch.empty(6 * n + 2 * slots * nr * nc * (MOMENTS + 1), dtype=torch.float32,
                           device=S.device)
        kernels.launch("vt_gn_loop_euclidean_stack", "gn_moments_euclidean", S.device,
                       S.data_ptr(), t.data_ptr(), m.data_ptr(), seed.data_ptr(),
                       work.data_ptr(), work.data_ptr() + 4 * 6 * n, n, h, w, int(K), nr, nc,
                       int(max_iters), float(eps), int(stall_patience))
        return work[:6 * n].reshape(n, 6)
    n_out = 6 if coeffs is None else 36
    work = torch.empty(n_out + 2 * nr * nc * MOMENTS, dtype=torch.float32, device=S.device)
    kernels.launch("vt_gn_loop_euclidean", "gn_moments_euclidean", S.device,
                   S.data_ptr(), t.data_ptr(), m.data_ptr(),
                   seed.data_ptr() if coeffs is None else None,
                   seed.data_ptr() if coeffs is not None else None,
                   work.data_ptr(), work.data_ptr() + 4 * n_out, h, w, int(K), nr, nc,
                   int(max_iters), float(eps), int(stall_patience))
    return work[:n_out]


def gn_moments_euclidean(S_cf: torch.Tensor, T: torch.Tensor, sm: torch.Tensor,
                         coeffs: torch.Tensor, K: int = 4) -> torch.Tensor:
    """(6, 6) ECC moment matrix for the centred stack ``S_cf`` = (4, H, W)
    [I, gx, gy, mask01], the centred template ``T``, the 0/1 statistics grid
    ``sm`` and the warp's 8 shear scalars ``coeffs`` (``shear_coeffs``)."""
    if kernels.route(S_cf) == "cpu":
        return gn_moments_euclidean_plain(S_cf, T, sm, coeffs, K)
    return _launch("gn_moments_euclidean", S_cf, T, sm, K, coeffs=coeffs).reshape(6, 6)


def gn_loop_euclidean(S_cf: torch.Tensor, T: torch.Tensor, sm: torch.Tensor,
                      p0: torch.Tensor, K: int = 4, max_iters: int = 300,
                      eps: float = 1e-7, stall_patience: int = 0):
    """The whole per-iteration ECC loop from the seed ``p0`` = (theta, tx,
    ty): ``S_cf``, ``T`` and ``sm`` as for ``gn_moments_euclidean``.
    Returns device tensors (p (3,), rho, n_iters, failed); failure handling
    (identity warp, NaN rho) stays with the caller.  A (B, 4, H, W) stack
    with (B, H, W) templates and (B, 3) seeds (``sm`` (H, W) or (B, H, W))
    is B solves in one launch, each bit for bit its own: (B, 3), (B,),
    (B,), (B,)."""
    if kernels.route(S_cf) == "cpu":
        return gn_loop_euclidean_plain(S_cf, T, sm, p0, K, max_iters, eps, stall_patience)
    out = _launch("gn_loop_euclidean", S_cf, T, sm, K, p0=p0.reshape(*T.shape[:-2], 3),
                  max_iters=max_iters, eps=eps, stall_patience=stall_patience)
    return out[..., :3], out[..., 3], out[..., 4].to(torch.int32), out[..., 5] > 0.5
