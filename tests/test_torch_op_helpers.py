"""The JAX package's public op helpers that no pipeline reaches, in the port
against their JAX functions on the CPU (and cv2 where the JAX test holds the
JAX function to it): ``inpaint_float32``, ``ecc_align_and_warp``,
``warp_affine_forward`` and ``translation_matrix``, ``sobel``,
``gray_dilate``, ``gray_erode`` and ``dilate_disk_px``.  Morphology is max
and min, so bit-equal; the rest within the float32 atol each test states.
"""
import cv2
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from vistaf_tpu.ops import filters as jfilt
from vistaf_tpu.ops import inpaint as jinpaint
from vistaf_tpu.ops import morphology as jmorph
from vistaf_tpu.ops import registration as jreg
from vistaf_tpu.ops import warp as jwarp

from torch_threads import single_torch_thread  # noqa: F401  (autouse)
from vistaf_torch.ops import filters as tfilt
from vistaf_torch.ops import inpaint as tinpaint
from vistaf_torch.ops import morphology as tmorph
from vistaf_torch.ops import registration as treg
from vistaf_torch.ops import warp as twarp
from vistaf_torch.ops.consts import DeviceConsts

T = torch.as_tensor


def J(a):
    return np.array(a)


def test_inpaint_float32_matches_jax(rng):
    """Non-finite pixels take the finite median, then the bad mask is
    diffused (``tests/test_pallas_inpaint.py``'s plane): within 1e-5."""
    img = (rng.random((48, 56)) * 10).astype(np.float32)
    img[5:9, 7:12] = np.nan
    img[30, 40] = np.inf
    bad = rng.random((48, 56)) > 0.85
    want = J(jinpaint.inpaint_float32(jnp.asarray(img), jnp.asarray(bad), iters=24))
    got = tinpaint.inpaint_float32(T(img), T(bad), iters=24).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_ecc_align_and_warp_translation_matches_jax(rng):
    """``tests/test_ops_registration.py::test_ecc_align_and_warp_translation``:
    the aligned plane matches the reference in the interior, and the port's
    warp is JAX's within 0.05 px (rho within 1e-4)."""
    ref = cv2.GaussianBlur(rng.random((100, 100)).astype(np.float32), (0, 0), 3) * 255
    M = np.array([[1, 0, 3.0], [0, 1, 1.5]], np.float32)
    mov = cv2.warpAffine(ref, M, (100, 100), flags=cv2.INTER_LINEAR | cv2.WARP_INVERSE_MAP,
                         borderMode=cv2.BORDER_REFLECT)
    mask = np.zeros((100, 100), dtype=bool)
    mask[10:90, 10:90] = True
    kw = dict(mode="translation", max_iters=100, eps=1e-6, gauss_filt=3.0)
    _, jw, jrho = jreg.ecc_align_and_warp(jnp.asarray(ref), jnp.asarray(mov), jnp.asarray(mask),
                                          **kw)
    aligned, w, rho = treg.ecc_align_and_warp(T(ref), T(mov), T(mask), DeviceConsts("cpu"), **kw)
    assert np.abs(aligned.numpy()[20:80, 20:80] - ref[20:80, 20:80]).mean() < 2.0
    np.testing.assert_allclose(w.numpy(), J(jw), atol=0.05)
    assert abs(float(rho) - float(jrho)) < 1e-4


def test_warp_affine_forward_and_translation_matrix_match(rng):
    """``tests/test_ops_warp.py::test_warp_affine_forward_matches_cv2``:
    within cv2's fixed-point interpolation of cv2, within 1e-3 of JAX."""
    img = (rng.random((40, 50)) * 255).astype(np.float32)
    M = twarp.translation_matrix(3.25, -2.5)
    np.testing.assert_array_equal(M.numpy(), J(jwarp.translation_matrix(3.25, -2.5)))
    ours = twarp.warp_affine_forward(T(img), M).numpy()
    ref = cv2.warpAffine(img, M.numpy(), (50, 40), flags=cv2.INTER_LINEAR,
                         borderMode=cv2.BORDER_REFLECT)
    np.testing.assert_allclose(ours, ref, atol=0.75)
    want = J(jwarp.warp_affine_forward(jnp.asarray(img), jnp.asarray(M.numpy())))
    np.testing.assert_allclose(ours, want, rtol=0, atol=1e-3)


def test_sobel_matches(rng):
    """``tests/test_ops_filters.py::test_sobel_matches_cv2``: the interior
    within 1e-3 of cv2, everywhere within 1e-4 of JAX."""
    img = (rng.random((40, 52)) * 255).astype(np.float32)
    for d in ((1, 0), (0, 1)):
        ours = tfilt.sobel(T(img), *d).numpy()
        ref = cv2.Sobel(img, cv2.CV_32F, *d, ksize=3)
        np.testing.assert_allclose(ours[1:-1, 1:-1], ref[1:-1, 1:-1], atol=1e-3)
        np.testing.assert_allclose(ours, J(jfilt.sobel(jnp.asarray(img), *d)), rtol=0,
                                   atol=1e-4)
    with pytest.raises(ValueError):
        tfilt.sobel(T(img), 1, 1)


def test_gray_morphology_and_disk_dilation_bit_equal(rng):
    """Grayscale dilation and erosion of a float plane by an ellipse, and
    the reference's disk dilation of a mask (px 0 the mask itself)."""
    x = (rng.random((37, 45)) * 100).astype(np.float32)
    fp = jmorph.ellipse_kernel(7, 5)
    np.testing.assert_array_equal(tmorph.gray_dilate(T(x), fp).numpy(),
                                  J(jmorph.gray_dilate(jnp.asarray(x), fp)))
    np.testing.assert_array_equal(tmorph.gray_erode(T(x), fp).numpy(),
                                  J(jmorph.gray_erode(jnp.asarray(x), fp)))
    np.testing.assert_array_equal(tmorph.gray_dilate(T(x), fp).numpy(),
                                  cv2.dilate(x, fp.astype(np.uint8)))
    mask = rng.random((37, 45)) > 0.97
    for px in (0, 1, 4):
        np.testing.assert_array_equal(tmorph.dilate_disk_px(T(mask), px).numpy(),
                                      J(jmorph.dilate_disk_px(jnp.asarray(mask), px)))
