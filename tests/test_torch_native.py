"""The port's bindings to the shared native library
(``vistaf_torch/runner/native.py``) and its batch decoder
(``runner/io.py::iter_images_bgr``) against the JAX package's, mirroring
``tests/test_native.py``.  That file decodes the reference's frames under
``/root/reference``, which is absent here; this one decodes seeded JPEGs
that cv2 writes into ``tmp_path``.  The decode tests skip where the
library does not build (a machine without libjpeg), as that file's do;
the gpfl parser and ``iter_images_bgr`` without the library run
everywhere.
"""
import os

import cv2
import numpy as np
import pytest

from vistaf_tpu.runner import io as jio
from vistaf_tpu.runner import native as jnative

from vistaf_torch.runner import io, native
from torch_threads import single_torch_thread  # noqa: F401  (autouse)

GPFL = """#V4L2/CTRL/0.0.2
APP{"guvcview"}
# control data
#Brightness
ID{0x00980900};CHK{-64:64:1:0}=VAL{0}
#White Balance Temperature
ID{0x0098091a};CHK{2800:6500:1:4600}=VAL{6297}
#Exposure Time, Absolute
ID{0x009a0902};CHK{1:5000:1:157}=VAL{6068}
#Pan
ID{0x009a0908};CHK{-36000:36000:3600:0}=VAL{-3600}
#Focus, Automatic Continuous
ID{0x009a090c};CHK{0:1:1:1}=VAL{0}
# not a control line
"""


def _jpegs(tmp_path, n=5, shape=(64, 96, 3)):
    rng = np.random.default_rng(0)
    paths = []
    for i in range(n):
        img = (rng.random(shape) * 255).astype(np.uint8)
        p = str(tmp_path / f"f{i}.jpg")
        assert cv2.imwrite(p, img, [cv2.IMWRITE_JPEG_QUALITY, 92])
        paths.append(p)
    return paths


def _need_native():
    if not native.native_available():
        pytest.skip("native library unavailable (it needs g++ and libjpeg)")


def test_the_port_loads_the_shared_library():
    assert os.path.realpath(native._LIB_PATH) == os.path.realpath(jnative._LIB_PATH)
    assert native.native_available() == jnative.native_available()


def test_native_jpeg_decode_bit_identical_to_cv2(tmp_path):
    _need_native()
    for p in _jpegs(tmp_path, 2, (120, 200, 3)):
        ours = native.decode_jpeg(p)
        np.testing.assert_array_equal(ours, cv2.imread(p, cv2.IMREAD_COLOR))
        np.testing.assert_array_equal(ours, jnative.decode_jpeg(p))
    assert native.decode_jpeg(str(tmp_path / "missing.jpg")) is None


def test_native_batch_decode(tmp_path):
    _need_native()
    paths = _jpegs(tmp_path, 3, (72, 128, 3))
    stack, status = native.decode_jpeg_batch(paths + [str(tmp_path / "missing.jpg")], 72, 128)
    jstack, jstatus = jnative.decode_jpeg_batch(paths, 72, 128)
    assert (status[:3] == 0).all() and status[3] != 0 and (jstatus == 0).all()
    assert stack.shape == (4, 72, 128, 3)
    for i, p in enumerate(paths):
        np.testing.assert_array_equal(stack[i], cv2.imread(p, cv2.IMREAD_COLOR))
        np.testing.assert_array_equal(stack[i], jstack[i])


def test_led_ring_without_a_device_raises_as_jax():
    _need_native()
    for mod in (native, jnative):
        with pytest.raises(RuntimeError, match="cannot open LED serial device"):
            mod.LedRing("/nonexistent/ttyACM9")


def test_parse_gpfl_matches_jax(tmp_path):
    p = tmp_path / "camera_config.gpfl"
    p.write_text(GPFL)
    ctrl = native.parse_gpfl(str(p))
    assert ctrl == jnative.parse_gpfl(str(p))
    d = dict(ctrl)
    assert d[0x009a0902] == 6068 and d[0x0098091a] == 6297 and d[0x009a090c] == 0
    assert d[0x009a0908] == -3600 and len(ctrl) == 5


@pytest.mark.parametrize("route", ["native", "cv2"])
def test_iter_images_bgr_matches_jax(tmp_path, route, monkeypatch):
    """Both packages' generators yield the same paths and pixels, in order,
    bit-identical to cv2.imread: through the native batch decoder (chunks
    of 2, a frame of another size falling back to cv2) and without it."""
    if route == "native":
        _need_native()
    else:
        monkeypatch.setattr(native, "native_available", lambda: False)
        monkeypatch.setattr(jnative, "native_available", lambda: False)
    paths = _jpegs(tmp_path)
    odd = str(tmp_path / "odd.jpg")
    assert cv2.imwrite(odd, np.full((40, 50, 3), 90, np.uint8))
    paths.insert(3, odd)
    got = list(io.iter_images_bgr(paths, chunk=2))
    want = list(jio.iter_images_bgr(paths, chunk=2))
    assert [p for p, _ in got] == [p for p, _ in want] == paths
    for (p, a), (_, b) in zip(got, want):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, io.imread_bgr(p))
    assert list(io.iter_images_bgr([])) == []
