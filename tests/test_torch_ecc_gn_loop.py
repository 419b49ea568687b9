"""K4's loop (``vistaf_torch/kernels/ecc_kernel.py::gn_loop_euclidean``) on
the CPU, and numpy models of what its kernel does differently from the plain
version: the Gauss-Newton tail's 3x3 LU solve and the tiled, fixed-order
moment sums.

On the CPU the wrapper runs its plain version (the host loop over the plain
moments); the JAX side is ``ecc_align(..., loop_kernel=False)``, which on
the CPU takes XLA's moments (``registration.py:231-232``), so the gates are
tolerances, each stated with its measured value.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from vistaf_tpu.ops import registration as jreg
from vistaf_tpu.ops.filters import gaussian_blur as j_blur
from vistaf_tpu.ops.warp import warp_affine_inverse_shear as j_shear

from vistaf_torch import kernels
from vistaf_torch.kernels import ecc_kernel
from vistaf_torch.ops.registration import ecc_prepare
from torch_threads import single_torch_thread  # noqa: F401  (autouse)

f32 = np.float32


def _scene(h, w, seed=31, th=0.003, tx=0.8, ty=-0.5):
    """A smooth template, its rotated and shifted copy and a disk mask."""
    rng = np.random.default_rng(seed)
    base = np.asarray(j_blur(jnp.asarray(rng.random((h, w)).astype(f32)), 3))
    M = np.array([[np.cos(th), -np.sin(th), tx], [np.sin(th), np.cos(th), ty]], f32)
    moved = np.asarray(j_shear(jnp.asarray(base), jnp.asarray(M)))
    yy, xx = np.mgrid[0:h, 0:w]
    mask = (yy - h / 2) ** 2 + (xx - w / 2) ** 2 <= (min(h, w) / 2 - 4) ** 2
    return base, moved, mask


def _prepared(base, moved, mask, stride=2):
    S, T = ecc_prepare(torch.as_tensor(base), torch.as_tensor(moved), torch.as_tensor(mask))
    sm = torch.zeros_like(T)
    sm[::stride, ::stride] = 1.0
    return S, T, sm


SEED = np.array([0.002, 0.6, -0.3], f32)


@pytest.mark.parametrize("patience", [0, 25])
@pytest.mark.parametrize("seeded", [False, True])
@pytest.mark.parametrize("shape", [(90, 110), (295, 295)])
def test_gn_loop_matches_jax(shape, seeded, patience):
    """Gate 0.05 px on the translation, 5e-5 rad on the angle and 1e-4 on
    rho (measured at most 5.4e-7 px, 3.3e-9 rad and 2.4e-7; 4 to 6
    iterations on either side)."""
    base, moved, mask = _scene(*shape)
    kw = dict(max_iters=300, eps=1e-7, stall_patience=patience)
    jw, jrho, jit = jreg.ecc_align(jnp.asarray(base), jnp.asarray(moved), jnp.asarray(mask),
                                   mode="euclidean", stride=2, sampler="shear", shear_k=4,
                                   loop_kernel=False,
                                   p_init=jnp.asarray(SEED) if seeded else None, **kw)
    S, T, sm = _prepared(base, moved, mask)
    p0 = torch.as_tensor(SEED) if seeded else torch.zeros(3)
    kernels.reset_launches()
    p, rho, it, failed = ecc_kernel.gn_loop_euclidean(S, T, sm, p0, 4, **kw)
    assert kernels.LAUNCHES["gn_moments_euclidean"] == 0    # CPU: the plain version
    jw = np.asarray(jw)
    assert not bool(failed) and 0 < int(it) <= 300
    assert abs(float(rho) - float(jrho)) < 1e-4
    np.testing.assert_allclose(p.numpy()[1:], jw[:, 2], atol=0.05)
    assert abs(float(p[0]) - np.arctan2(jw[1, 0], jw[0, 0])) < 5e-5


def lu_solve_model(H, B):
    """numpy float32 model of the kernel's tail solve (``LuSolve`` in
    csrc/ecc_gn_loop.cu): LU with partial pivoting in LAPACK sgetf2's order,
    then sgetrs (row swaps, unit-lower and upper solves of the reference
    strsm, skipping zero entries)."""
    A = np.array(H, f32)
    B = np.array(B, f32)
    piv = [0, 0, 0]
    tiny = np.finfo(f32).tiny
    for j in range(3):
        p = j
        big = abs(A[j, j])
        for i in range(j + 1, 3):
            if abs(A[i, j]) > big:
                big, p = abs(A[i, j]), i
        piv[j] = p
        if A[p, j] != 0:
            A[[j, p]] = A[[p, j]]
            if abs(A[j, j]) >= tiny:
                r = f32(1.0) / A[j, j]
                A[j + 1:, j] = A[j + 1:, j] * r
            else:
                A[j + 1:, j] = A[j + 1:, j] / A[j, j]
        for i in range(j + 1, 3):
            for k in range(j + 1, 3):
                A[i, k] = A[i, k] + A[i, j] * (-A[j, k])
    for j in range(3):
        B[[j, piv[j]]] = B[[piv[j], j]]
    for c in range(B.shape[1]):
        for k in range(3):
            if B[k, c] != 0:
                for i in range(k + 1, 3):
                    B[i, c] = B[i, c] - B[k, c] * A[i, k]
        for k in range(2, -1, -1):
            if B[k, c] != 0:
                B[k, c] = B[k, c] / A[k, k]
                for i in range(k):
                    B[i, c] = B[i, c] - B[k, c] * A[i, k]
    return B


def _tail(M, solve):
    """(u, v, lam, dp) of one Gauss-Newton step from the (6, 6) float32 moments,
    in the kernel's order (``gn_step`` in csrc/ecc_common.cuh)."""
    n = max(M[0, 0], f32(1.0))
    st, si = M[0, 1], M[0, 2]
    sg = M[0, 3:]
    corr = M[1, 2] - st * si / n
    inorm2 = M[2, 2] - si * si / n
    Gt = M[1, 3:] - (st / n) * sg
    Gi = M[2, 3:] - (si / n) * sg
    H = M[3:, 3:] + f32(1e-12) * np.eye(3, dtype=f32)
    UV = solve(H, np.stack([Gt, Gi], axis=1))
    u, v = UV[:, 0], UV[:, 1]
    lam_num = inorm2 - ((Gi[0] * v[0] + Gi[1] * v[1]) + Gi[2] * v[2])
    lam_den = corr - ((Gt[0] * v[0] + Gt[1] * v[1]) + Gt[2] * v[2])
    lam = lam_num / (f32(1e-12) if abs(lam_den) < 1e-12 else lam_den)
    return u, v, lam, lam * u - v


def test_lu_tail_model_matches_solve_ex():
    """The kernel's LU tail against ``torch.linalg.solve_ex`` (the plain
    version's) on every moment matrix of the 295^2 coarse solve (H's
    condition number ~2.9e5): u and v within 1e-5 of their largest entry
    (measured 4.0e-7), the step dp = lam u - v within 1e-5 of its terms'
    scale |lam| max|u| + max|v| (measured 3.3e-7; near convergence dp is a
    cancellation, 5.8e-3 of its own largest entry)."""
    base, moved, mask = _scene(295, 295)
    S, T, sm = _prepared(base, moved, mask)
    mats = []

    def moments(q):
        M = ecc_kernel.gn_moments_euclidean_plain(S, T, sm, ecc_kernel.shear_coeffs(q), 4)
        mats.append(M.numpy().astype(f32))
        return M

    ecc_kernel.gn_loop(moments, torch.zeros(3), 300, 1e-7, 25)
    assert len(mats) >= 3

    def torch_solve(H, B):
        return torch.linalg.solve_ex(torch.as_tensor(H), torch.as_tensor(B))[0].numpy()

    for M in mats:
        gu, gv, _, gd = _tail(M, lu_solve_model)
        wu, wv, lam, wd = _tail(M, torch_solve)
        assert np.abs(gu - wu).max() <= 1e-5 * np.abs(wu).max()
        assert np.abs(gv - wv).max() <= 1e-5 * np.abs(wv).max()
        scale = abs(lam) * np.abs(wu).max() + np.abs(wv).max()
        assert np.abs(gd - wd).max() <= 1e-5 * scale, (gd, wd)


def test_lu_model_pivots():
    """The model (and so the kernel's order) swaps rows to the largest
    pivot: a matrix whose leading entry is 0 still solves exactly."""
    H = np.array([[0.0, 2.0, 1.0], [1.0, 1.0, 0.0], [4.0, 0.0, 2.0]], f32)
    x = np.array([[1.0, -2.0], [0.5, 3.0], [-1.0, 0.25]], f32)
    B = (H.astype(np.float64) @ x).astype(f32)
    np.testing.assert_allclose(lu_solve_model(H, B), x, rtol=0, atol=1e-6)


def tile_bounds(n, parts, i):
    """[start, end) of part i of n rows or columns cut into ``parts``: the
    kernel's balanced split (``gn_loop_kernel``'s v0, v1 and c0, c1)."""
    return i * n // parts, (i + 1) * n // parts


def moments_model(rows, h, w, nr, nc):
    """numpy float32 model of the kernel's moment sums: each CTA's tile
    (``tile_bounds``), its pixels row-major dealt to ``THREADS`` threads that
    each add their products in order, the block reduction (a butterfly in
    each warp, then one over the warps' sums), then lane l of a warp adding
    CTAs l, l + 32, ... in order and a butterfly.  Returns the 21 upper
    triangle sums and how often each pixel was counted."""
    T = ecc_kernel.THREADS
    iu = np.triu_indices(6)
    prods = (rows[:, None, :] * rows[None, :, :])[iu]         # (21, h*w)
    seen = np.zeros(h * w, np.int32)

    def butterfly(v):                                          # over the last axis (32)
        lanes = np.arange(32)
        for o in (16, 8, 4, 2, 1):
            v = v + v[..., lanes ^ o]
        return v

    partials = []
    for ti in range(nr):
        v0, v1 = tile_bounds(h, nr, ti)
        for tj in range(nc):
            c0, c1 = tile_bounds(w, nc, tj)
            pix = (np.arange(v0, v1)[:, None] * w + np.arange(c0, c1)[None, :]).ravel()
            seen[pix] += 1
            rounds = -(-pix.size // T)
            P = np.zeros((21, rounds * T), f32)
            P[:, :pix.size] = prods[:, pix]
            acc = np.zeros((21, T), f32)
            for r in range(rounds):
                acc = acc + P[:, r * T:(r + 1) * T]
            warps = butterfly(acc.reshape(21, T // 32, 32))[..., 0]
            second = np.zeros((21, 32), f32)
            second[:, :T // 32] = warps
            partials.append(butterfly(second)[:, 0])
    part = np.stack(partials, axis=1)                          # (21, CTAs)
    lanes = np.zeros((21, 32), f32)
    for b in range(part.shape[1]):
        lanes[:, b % 32] = lanes[:, b % 32] + part[:, b]
    return butterfly(lanes)[:, 0], seen


@pytest.mark.parametrize("shape,K,ctas", [((295, 295), 4, 132), ((295, 295), 4, 114),
                                          ((90, 110), 4, 132), ((97, 1920), 4, 132),
                                          ((8, 24960), 4, 132), ((300, 600), 6, 132)])
def test_tile_plan_and_sum_order_model(shape, K, ctas):
    """The tiling covers every pixel once and fits a CTA's shared memory; the
    kernel's summation order (modelled in numpy float32) agrees with the
    plain ``rows @ rows.T`` within 1e-5 of each entry's Cauchy-Schwarz scale
    sqrt(M_ii M_jj) (measured at most 1.0e-7)."""
    h, w = shape
    assert ecc_kernel.fits(shape)
    nr, nc = ecc_kernel.tile_plan(h, w, K, ctas)
    assert nr * nc <= ctas and nr <= h and nc <= w
    assert ecc_kernel.tile_bytes(h, w, K, nr, nc) <= ecc_kernel.MAX_SMEM_BYTES
    rng = np.random.default_rng(32)
    S = torch.as_tensor(rng.random((4, h, w)).astype(f32))
    S[3] = (S[3] > 0.2).float()
    Tt = torch.as_tensor(rng.random((h, w)).astype(f32) - 0.5)
    sm = torch.zeros((h, w))
    sm[::2, ::2] = 1.0
    co = ecc_kernel.shear_coeffs(torch.tensor([0.003, 0.4, -0.7]))
    rows = ecc_kernel.moment_rows(S, Tt, sm, [co[i] for i in range(8)], K).numpy()
    got, seen = moments_model(rows, h, w, nr, nc)
    assert (seen == 1).all()
    want = (rows.astype(np.float64) @ rows.T.astype(np.float64))
    scale = np.sqrt(np.outer(np.diag(want), np.diag(want)))[np.triu_indices(6)]
    assert (np.abs(got - want[np.triu_indices(6)]) <= 1e-5 * scale).all()


def test_tile_plan_at_the_coarse_grid():
    """295^2 on 132 SMs: two thread rounds a pass in under 100 CTAs, within
    the shared memory a CTA may take."""
    nr, nc = ecc_kernel.tile_plan(295, 295, 4, 132)
    rh, cw = -(-295 // nr), -(-295 // nc)
    assert rh * min(295, cw + 8) <= 2 * ecc_kernel.THREADS
    assert nr * nc <= 100
