"""The bisection ladder of K1 (``vistaf_torch/csrc/quantile.cu``) as a numpy
model, bit-equal to ``masked_quantiles_plain``.

K1 takes the bisection's levels ``bits`` at a time: it builds the midpoints
of the next ``bits`` levels of the bisection tree (each ``0.5f * (lo + hi)``
of its own sub-bracket), sends every valid element down that tree (left
where ``x <= mid``) to a leaf, counts the leaves, and walks the tree with
``count(x <= node)`` = the sum of the leaves left of the node's split.  The
model below does the same in float32 on the CPU, so this test argues the
equality the kernel relies on: ties, single elements, empty masks, NaN in
the mask, signed zeros and denormals, and ranges where ``lo + hi``
overflows to an infinity, at ladder widths 1, 4 and 8 and at 0, 7, 16 and
23 levels (K1's ``LEVELS``), with 8 quantiles a call as on the card.
"""
import numpy as np
import pytest
import torch

from vistaf_torch.kernels.quantile_kernel import masked_quantiles_plain

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


def ladder_quantiles(x, m, qs, levels, bits):
    """K1's ladder on one plane: (len(qs),) float32."""
    x = x.astype(np.float32).ravel()
    valid = m.ravel() & np.isfinite(x)
    v = x[valid]
    n = v.size
    lo = v.min() if n else F(np.inf)
    hi = v.max() if n else F(-np.inf)
    if n < x.size:        # the plain version's where(valid, x, +-3e38) extremes
        lo, hi = min(lo, BIG), max(hi, -BIG)
    out = []
    for q in qs:
        target = F(q / 100.0) * max(F(n) - F(1.0), F(0.0))
        a, b = F(lo), F(hi)
        done = 0
        while done < levels:
            bb = min(bits, levels - done)
            leaves = 1 << bb
            tree = np.zeros(leaves, np.float32)
            for node in range(1, leaves):
                tree[node] = _node_midpoint(a, b, node)
            node = np.ones(n, np.int64)
            for _ in range(bb):
                node = 2 * node + (v > tree[node])
            hist = np.bincount(node - leaves, minlength=leaves)
            below, first = 0, 0
            for d in range(bb):
                half = 1 << (bb - d - 1)
                c = below + int(hist[first:first + half].sum())
                mid = F(0.5) * (a + b)
                if F(c) <= target:
                    a, below, first = mid, c, first + half
                else:
                    b = mid
            done += bb
        out.append(F(0.5) * (a + b) if n else F(0.0))
    return np.asarray(out, np.float32)


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
