"""Connected components of the port against the JAX package, on the CPU,
bit for bit, and a model of the labelling kernel (``csrc/ccl.cu``).

The masks are made from a seed with numpy: random fields at densities 0.3,
0.5 and 0.7 (below, near and above 8-connected site percolation), a
one-pixel-wide spiral (the longest geodesic a mask of its size holds),
chains linked only through diagonal corners, and the empty, full and
single-pixel masks, at 64x96 and 240x320.  The spiral runs at 64x96 only:
at 240x320 its 38,720-pixel path takes the plain reconstruction loop some
4,800 rounds (35 s on one thread).  Each function is held to its JAX
counterpart: ``label``, ``reconstruct`` (the CPU's dilation loop and the
card's route from the labels, ``reconstruct_by_labels``),
``dominant_component`` under ``seed_pool`` 1 and 4 (the random, diagonal and
single-pixel masks have no interior at the pooled scale, so the pick falls
to the full-resolution seed), ``largest_component`` and
``filter_components_by_peak`` without and with an area bound.

The kernel model repeats ``csrc/ccl.cu``'s three launches in numpy: the
tile unions on a tile-local parent array, the unions across tile borders and
the path flattening, with its tile shape read from the source.  The card
runs the unions concurrently; the model applies them one at a time in
several shuffled orders, and every order must give the plain labels.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vistaf_tpu.ops import components as jcomp
from vistaf_tpu.ops import morphology as jmorph

from vistaf_torch.kernels import ccl_kernel
from vistaf_torch.ops import components as tcomp
from vistaf_torch.ops import morphology as tmorph
from torch_threads import single_torch_thread  # noqa: F401  (autouse)

SIZES = ((64, 96), (240, 320))
KINDS = ("d30", "d50", "d70", "spiral", "diagonal", "empty", "full", "single")


def spiral(h, w):
    """A one-pixel-wide path winding inwards from the top-left corner, one
    free pixel between its turns."""
    m = np.zeros((h, w), bool)
    dirs = ((0, 1), (1, 0), (0, -1), (-1, 0))
    y = x = d = turns = 0
    m[0, 0] = True
    while turns < 2:
        dy, dx = dirs[d]
        ny, nx, ay, ax = y + dy, x + dx, y + 2 * dy, x + 2 * dx
        ahead_free = not (0 <= ay < h and 0 <= ax < w) or not m[ay, ax]
        if 0 <= ny < h and 0 <= nx < w and not m[ny, nx] and ahead_free:
            y, x = ny, nx
            m[y, x] = True
            turns = 0
        else:
            d, turns = (d + 1) % 4, turns + 1
    return m


def diagonal(h, w):
    """Chains linked only through diagonal corners: lines of slope +1 and -1,
    three pixels apart, and a zigzag of diagonal steps along the bottom."""
    yy, xx = np.mgrid[0:h, 0:w]
    m = ((xx - yy) % 6 == 0) & (xx < w // 2)
    m |= ((xx + yy) % 6 == 0) & (xx > w // 2 + 2) & (yy < h - 8)
    zig = (h - 4) + np.abs((xx % 8) - 4) // 2 - 1
    return m | ((yy == zig) & (yy >= h - 6))


def make_mask(kind, h, w):
    rng = np.random.default_rng([KINDS.index(kind), h, w])
    if kind in ("d30", "d50", "d70"):
        return rng.random((h, w)) < int(kind[1:]) / 100.0
    if kind == "spiral":
        return spiral(h, w)
    if kind == "diagonal":
        return diagonal(h, w)
    m = np.full((h, w), kind == "full")
    if kind == "single":
        m[h // 3, w // 2] = True
    return m


CASES = [(k, h, w) for h, w in SIZES for k in KINDS if not (k == "spiral" and h > 64)]
IDS = [f"{k}-{h}x{w}" for k, h, w in CASES]
# dominant_component at 64x96 only: each shape costs one XLA compile of the
# JAX distance transform (its 9 unrolled jump-flooding rounds), 12 to 26 s
SMALL = [c for c in CASES if c[1] == 64]
SMALL_IDS = [f"{k}-{h}x{w}" for k, h, w in SMALL]


def T(a):
    return torch.as_tensor(np.ascontiguousarray(a))


def seeds(mask, kind):
    """A few seed pixels, in and out of the mask; the spiral's at its far
    end from the labels' root."""
    rng = np.random.default_rng([7, *mask.shape])
    s = rng.random(mask.shape) > 0.998
    if kind == "spiral":
        ys, xs = np.nonzero(mask)
        s[ys[-1], xs[-1]] = True
    return s


@pytest.mark.parametrize("kind,h,w", CASES, ids=IDS)
def test_label_and_reconstruct_match_jax(kind, h, w):
    m = make_mask(kind, h, w)
    want = np.asarray(jcomp.label(jnp.asarray(m)))
    np.testing.assert_array_equal(tcomp.label(T(m)).numpy(), want)
    s = seeds(m, kind)
    want_r = np.asarray(jmorph.reconstruct(jnp.asarray(s), jnp.asarray(m)))
    np.testing.assert_array_equal(tmorph.reconstruct(T(s), T(m)).numpy(), want_r)
    np.testing.assert_array_equal(tmorph.reconstruct_by_labels(T(s), T(m)).numpy(), want_r)


@pytest.mark.parametrize("seed_pool", [1, 4])
@pytest.mark.parametrize("kind,h,w", SMALL, ids=SMALL_IDS)
def test_dominant_component_matches_jax(kind, h, w, seed_pool):
    m = make_mask(kind, h, w)
    want = np.asarray(jcomp.dominant_component(jnp.asarray(m), seed_pool=seed_pool))
    np.testing.assert_array_equal(tcomp.dominant_component(T(m), seed_pool).numpy(), want)


@pytest.mark.parametrize("kind,h,w", CASES, ids=IDS)
def test_largest_component_matches_jax(kind, h, w):
    m = make_mask(kind, h, w)
    np.testing.assert_array_equal(tcomp.largest_component(T(m)).numpy(),
                                  np.asarray(jcomp.largest_component(jnp.asarray(m))))


@pytest.mark.parametrize("min_area", [0, 12])
@pytest.mark.parametrize("kind,h,w", CASES, ids=IDS)
def test_filter_components_by_peak_matches_jax(kind, h, w, min_area):
    m = make_mask(kind, h, w)
    v = np.random.default_rng([11, h, w]).random((h, w)).astype(np.float32)
    thr = np.float32(0.995)
    want = np.asarray(jcomp.filter_components_by_peak(jnp.asarray(m), jnp.asarray(v),
                                                      jnp.asarray(thr), min_area_px=min_area))
    got = tcomp.filter_components_by_peak(T(m), T(v), T(thr), min_area_px=min_area)
    np.testing.assert_array_equal(got.numpy(), want)


def test_pooled_seed_pick_takes_either_seed():
    """Both branches of the JAX ``lax.cond`` that ``dominant_component``
    runs as a ``device_if``: a disk with a pooled interior takes the
    pooled seed, a mask without one the full-resolution seed, and both pick
    the component JAX keeps."""
    yy, xx = np.mgrid[0:64, 0:96]
    disks = ((yy - 30) ** 2 + (xx - 30) ** 2 <= 14 ** 2) | ((yy - 40) ** 2 + (xx - 75) ** 2
                                                          <= 9 ** 2)
    thin = np.zeros((64, 96), bool)
    thin[10, 5:60] = thin[40:43, 70:90] = True
    for m in (disks, thin):
        want = np.asarray(jcomp.dominant_component(jnp.asarray(m), seed_pool=4))
        np.testing.assert_array_equal(tcomp.dominant_component(T(m), 4).numpy(), want)
        assert 0 < want.sum() < m.sum()


# ------------------------------------------------------------------ kernel model
def _tile_shape():
    src = (Path(ccl_kernel.__file__).resolve().parent.parent / "csrc" / "ccl.cu").read_text()
    th, tw = re.search(r"constexpr int kTileH = (\d+), kTileW = (\d+)", src).groups()
    return int(th), int(tw)


def _find(L, x):
    while L[x] != x:
        x = L[x]
    return x


def _unite(L, a, b):
    """``unite`` of csrc/ccl.cu, one union at a time (atomicMin as min)."""
    a, b = _find(L, a), _find(L, b)
    while a != b:
        if a < b:
            a, b = b, a
        old = L[a]
        L[a] = min(old, b)
        if old == a:
            return
        a = old


def _pairs(mask, y, x, keep):
    """(y, x)'s W, NW, N and NE foreground neighbours that ``keep`` admits."""
    h, w = mask.shape
    for dy, dx in ((0, -1), (-1, -1), (-1, 0), (-1, 1)):
        ny, nx = y + dy, x + dx
        if 0 <= ny < h and 0 <= nx < w and mask[ny, nx] and keep(ny, nx):
            yield ny, nx


def kernel_model(mask, rng):
    """csrc/ccl.cu's tile, border and flatten launches, each launch's unions
    applied in a shuffled order."""
    th, tw = _tile_shape()
    h, w = mask.shape
    L = np.arange(h * w)
    for y0 in range(0, h, th):
        for x0 in range(0, w, tw):
            s = list(range(th * tw))
            local = lambda y, x: (y - y0) * tw + (x - x0)      # noqa: E731
            inside = lambda y, x: y >= y0 and x0 <= x < x0 + tw  # noqa: E731
            pairs = [(local(y, x), local(*n)) for y in range(y0, min(y0 + th, h))
                     for x in range(x0, min(x0 + tw, w)) if mask[y, x]
                     for n in _pairs(mask, y, x, inside)]
            for i in rng.permutation(len(pairs)):
                _unite(s, *pairs[i])
            for y in range(y0, min(y0 + th, h)):
                for x in range(x0, min(x0 + tw, w)):
                    r = _find(s, local(y, x)) if mask[y, x] else local(y, x)
                    L[y * w + x] = (y0 + r // tw) * w + x0 + r % tw
    pairs = [(y * w + x, ny * w + nx) for y in range(h) for x in range(w) if mask[y, x]
             for ny, nx in _pairs(mask, y, x,
                                  lambda ny, nx, y=y, x=x: (ny // th, nx // tw) != (y // th,
                                                                                     x // tw))]
    for i in rng.permutation(len(pairs)):
        _unite(L, *pairs[i])
    return np.array([_find(L, i) if v else -1 for i, v in enumerate(mask.reshape(-1))]
                    ).reshape(h, w)


@pytest.mark.parametrize("kind,h,w", [("d30", 64, 96), ("d50", 64, 96), ("d70", 64, 96),
                                      ("spiral", 64, 96), ("diagonal", 64, 96),
                                      ("single", 64, 96), ("d50", 37, 70),
                                      ("spiral", 37, 70)],
                         ids=lambda v: str(v))
def test_kernel_model_matches_plain_labels(kind, h, w):
    """The model's labels equal the plain version's in every union order,
    partial tiles (37x70: a 5-row and a 6-column remainder) included."""
    m = make_mask(kind, h, w)
    want = ccl_kernel.label_components_plain(T(m)).numpy()
    for order in range(3):
        np.testing.assert_array_equal(kernel_model(m, np.random.default_rng(order)), want)
