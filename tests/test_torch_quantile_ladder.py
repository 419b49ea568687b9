"""The bisection ladder of K1 and K2 (``vistaf_torch/csrc/ladder.cuh``) as a
numpy model, bit-equal to ``masked_quantiles_plain`` and
``masked_median_mad_plain``.

The ladder takes the bisection's levels ``bits`` at a time: it builds the
midpoints of the next ``bits`` levels of the bisection tree (each
``0.5f * (lo + hi)`` of its own sub-bracket), sends every valid element down
that tree (left where ``x <= mid``) to a leaf, counts the leaves, and walks
the tree with ``count(x <= node)`` = the sum of the leaves left of the node's
split.  Every pass first replays the walk of the earlier passes from their
histograms, as every CTA does on the card; K2's MAD passes also replay the
median's whole walk, then bin ``|x - med|`` over ``[0, max(hi - med, med -
lo)]``.  The model does the same in float32 on the CPU, so these tests argue
the equality the kernels rely on: ties, single elements, empty masks, NaN in
the mask, signed zeros and denormals, ranges where ``lo + hi`` overflows to
an infinity, and (K2) a MAD bracket whose top overflows to +inf, at ladder
widths 1, 4 and 8 and at 0, 7, 16 and 23 levels (K1's ``LEVELS``), with 8
quantiles a call as on the card.
"""
import functools

import numpy as np
import pytest
import torch

from vistaf_torch.kernels import quantile_kernel
from vistaf_torch.kernels.quantile_kernel import masked_median_mad_plain, masked_quantiles_plain
from torch_threads import single_torch_thread  # noqa: F401  (autouse)

F = np.float32
BIG = F(3.0e38)
QS8 = (0.0, 1.0, 12.5, 25.0, 50.0, 75.0, 99.9, 100.0)


def _node_midpoint(a, b, node):
    """Midpoint of heap node ``node`` (root 1) of the tree over [a, b]."""
    for k in range(node.bit_length() - 2, -1, -1):
        m = F(0.5) * (a + b)
        if (node >> k) & 1:
            a = m
        else:
            b = m
    return F(0.5) * (a + b)


def _bin(v, a, b, bits):
    """Leaf counts of the values ``v`` in the ``bits``-level tree over [a, b]."""
    leaves = 1 << bits
    tree = np.zeros(leaves, np.float32)
    for node in range(1, leaves):
        tree[node] = _node_midpoint(a, b, node)
    node = np.ones(v.size, np.int64)
    for _ in range(bits):
        node = 2 * node + (v > tree[node])
    return np.bincount(node - leaves, minlength=leaves)


def _walk(hists, a, b, target):
    """The bisection's decisions from the leaf counts of each pass."""
    for hist in hists:
        bits = hist.size.bit_length() - 1
        below, first = 0, 0
        for d in range(bits):
            half = 1 << (bits - d - 1)
            c = below + int(hist[first:first + half].sum())
            mid = F(0.5) * (a + b)
            if F(c) <= target:
                a, below, first = mid, c, first + half
            else:
                b = mid
    return a, b


def _ladder(v, a, b, target, levels, bits):
    """The histograms of a ladder over ``v`` from [a, b]; each pass walks the
    earlier passes' histograms to its bracket."""
    hists = []
    for done in range(0, levels, bits):
        pa, pb = _walk(hists, a, b, target)
        hists.append(_bin(v, pa, pb, min(bits, levels - done)))
    return hists


def _valid(x, m):
    """The valid values of a plane, their count and the bracket [lo, hi]."""
    x = x.astype(np.float32).ravel()
    valid = m.ravel() & np.isfinite(x)
    v = x[valid]
    n = v.size
    lo = v.min() if n else F(np.inf)
    hi = v.max() if n else F(-np.inf)
    if n < x.size:        # the plain version's where(valid, x, +-3e38) extremes
        lo, hi = min(lo, BIG), max(hi, -BIG)
    return v, n, F(lo), F(hi)


def ladder_quantiles(x, m, qs, levels, bits):
    """K1's ladder on one plane: (len(qs),) float32."""
    v, n, lo, hi = _valid(x, m)
    out = []
    for q in qs:
        target = F(q / 100.0) * max(F(n) - F(1.0), F(0.0))
        a, b = _walk(_ladder(v, lo, hi, target, levels, bits), lo, hi, target)
        out.append(F(0.5) * (a + b) if n else F(0.0))
    return np.asarray(out, np.float32)


def ladder_median_mad(x, m, levels, bits):
    """K2's ladders on one plane: the median's, then the MAD's over
    |x - med| in [0, max(hi - med, med - lo)], each MAD pass replaying the
    median's walk first.  Returns (median, MAD) as float32."""
    v, n, lo, hi = _valid(x, m)
    target = F(0.5) * max(F(n) - F(1.0), F(0.0))
    med_hists = _ladder(v, lo, hi, target, levels, bits)

    def median_and_span():
        a, b = _walk(med_hists, lo, hi, target)
        med = F(0.5) * (a + b)
        return med, np.maximum(hi - med, med - lo)

    mad_hists = []
    for done in range(0, levels, bits):
        med, span = median_and_span()
        a, b = _walk(mad_hists, F(0.0), span, target)
        mad_hists.append(_bin(np.abs(v - med), a, b, min(bits, levels - done)))
    med, span = median_and_span()
    a, b = _walk(mad_hists, F(0.0), span, target)
    return (med, F(0.5) * (a + b)) if n else (F(0.0), F(0.0))


def _case(name):
    rng = np.random.default_rng(3)
    h, w = 23, 31
    x = rng.normal(size=(h, w)).astype(np.float32)
    m = rng.random((h, w)) > 0.3
    if name == "ties":
        x = rng.integers(0, 4, size=(h, w)).astype(np.float32)
    elif name == "all_equal":
        x[:] = 2.5
    elif name == "single_element":
        m[:] = False
        m[4, 9] = True
    elif name == "empty_mask":
        m[:] = False
    elif name == "nan_inside_mask":
        x[rng.random((h, w)) > 0.7] = np.nan
        x[0, :3] = (np.inf, -np.inf, np.nan)
        m[0, :3] = True
    elif name == "zeros_and_denormals":
        x = rng.choice(np.array([-0.0, 0.0, 1e-45, -1e-45, 3e-42, -7e-40, 1e-38],
                                np.float32), size=(h, w))
    elif name == "near_max_full_mask":       # lo + hi overflows to +inf
        x = rng.uniform(2.9e38, 3.4e38, size=(h, w)).astype(np.float32)
        m[:] = True
    elif name == "near_minus_max":           # lo + hi overflows to -inf
        x = -rng.uniform(2.9e38, 3.4e38, size=(h, w)).astype(np.float32)
    elif name == "overflow_inside_tree":     # the root's sum fits, a child's overflows
        x = rng.uniform(0.5e38, 2.3e38, size=(h, w)).astype(np.float32)
        m[:] = True
    elif name == "span_overflow":            # med near -3e38, x near +3e38: hi - med = +inf
        x = -rng.uniform(2.9e38, 3.4e38, size=(h, w)).astype(np.float32)
        x[rng.random((h, w)) > 0.8] *= -1.0
    return x, m


CASES = ["random", "ties", "all_equal", "single_element", "empty_mask",
         "nan_inside_mask", "zeros_and_denormals", "near_max_full_mask",
         "near_minus_max", "overflow_inside_tree"]


@pytest.mark.parametrize("levels", [0, 7, 16, 23])
@pytest.mark.parametrize("bits", [1, 4, 8])
@pytest.mark.parametrize("case", CASES)
def test_ladder_bit_equal_to_plain(case, bits, levels):
    x, m = _case(case)
    want = masked_quantiles_plain(torch.as_tensor(x), torch.as_tensor(m), QS8,
                                  levels).numpy()
    with np.errstate(over="ignore"):
        got = ladder_quantiles(x, m, QS8, levels, bits)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("levels", [0, 7, 16])
@pytest.mark.parametrize("bits", [1, 4, 8])
@pytest.mark.parametrize("case", CASES + ["span_overflow"])
def test_mad_ladder_bit_equal_to_plain(case, bits, levels, monkeypatch):
    x, m = _case(case)
    # the plain version at `levels` (it takes MAD_LEVELS, 16, from median_mad_rows)
    monkeypatch.setattr(quantile_kernel, "median_mad_rows",
                        functools.partial(quantile_kernel.median_mad_rows, levels=levels))
    want = [t.numpy() for t in masked_median_mad_plain(torch.as_tensor(x), torch.as_tensor(m))]
    with np.errstate(over="ignore"):
        got = ladder_median_mad(x, m, levels, bits)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g, np.float32).view(np.int32),
                                      np.asarray(w, np.float32).view(np.int32))


def test_span_overflow_reaches_infinity():
    """The case holds what it is named for: at 16 levels the median lies near
    -3e38 and the MAD bracket's top, hi - med, overflows to +inf."""
    x, m = _case("span_overflow")
    hi = _valid(x, m)[3]
    with np.errstate(over="ignore"):
        med, _ = ladder_median_mad(x, m, 16, 8)
        assert med < F(-1e38) and np.isinf(hi - med)

