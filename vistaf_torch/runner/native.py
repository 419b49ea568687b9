"""ctypes bindings for the native runtime (native/vistaf_native.cpp), the
JAX package's ``runner/native.py`` over the same shared library.

The library in ``native/`` is shared with the JAX package, not copied: it
is built there on first use (``make``: g++ and libjpeg).  Where it cannot
be built or loaded (a machine without libjpeg) ``native_available()`` is
False and the callers take their cv2 route: the batch JPEG decoder of
``runner/io.py::iter_images_bgr`` decodes file by file.
"""
from __future__ import annotations

import ctypes
import os
import re
import subprocess
from typing import List, Optional, Sequence, Tuple

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..", "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libvistaf_native.so")
_lib = None


def _load() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(_LIB_PATH):
        try:
            subprocess.run(["make", "-C", _NATIVE_DIR], check=True,
                           capture_output=True, timeout=120)
        except Exception:
            return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:
        return None

    lib.vistaf_decode_jpeg.restype = ctypes.c_int
    lib.vistaf_decode_jpeg.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32)]
    lib.vistaf_decode_jpeg_batch.restype = ctypes.c_int
    lib.vistaf_decode_jpeg_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int32,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.POINTER(ctypes.c_int32)]
    lib.vistaf_led_open.restype = ctypes.c_int
    lib.vistaf_led_open.argtypes = [ctypes.c_char_p]
    lib.vistaf_led_command.restype = ctypes.c_int
    lib.vistaf_led_command.argtypes = [ctypes.c_int, ctypes.c_char_p]
    lib.vistaf_led_close.restype = ctypes.c_int
    lib.vistaf_led_close.argtypes = [ctypes.c_int]
    _lib = lib
    return lib


def native_available() -> bool:
    return _load() is not None


# ---------------------------------------------------------------------------
# JPEG decode
# ---------------------------------------------------------------------------

def decode_jpeg(path: str) -> Optional[np.ndarray]:
    """Decode one JPEG to BGR uint8 via the native library; None on failure."""
    lib = _load()
    if lib is None:
        return None
    # probe dims via a generous first attempt
    cap = 4096 * 4096 * 3
    buf = np.empty(cap, np.uint8)
    h = ctypes.c_int32()
    w = ctypes.c_int32()
    rc = lib.vistaf_decode_jpeg(
        path.encode(), buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        cap, ctypes.byref(h), ctypes.byref(w))
    if rc != 0:
        return None
    return buf[:h.value * w.value * 3].reshape(h.value, w.value, 3).copy()


def decode_jpeg_batch(paths: Sequence[str], h: int, w: int,
                      threads: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Decode many same-size JPEGs concurrently into an (N, h, w, 3) BGR
    stack.  Returns (stack, status) with status[i] == 0 on success."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    n = len(paths)
    out = np.empty((n, h, w, 3), np.uint8)
    status = np.empty(n, np.int32)
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    lib.vistaf_decode_jpeg_batch(
        arr, n, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        h, w, threads, status.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return out, status


# ---------------------------------------------------------------------------
# LED ring (WS2812.ino host counterpart)
# ---------------------------------------------------------------------------

class LedRing:
    """Serial client for the illumination LED ring.

    Protocol per the firmware (WS2812.ino:22-44): newline-terminated "on"
    lights every other of the 24 pixels at RGB(210, 245, 125), brightness
    30; "off" clears.
    """

    def __init__(self, device: str = "/dev/ttyACM0"):
        lib = _load()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        self._fd = lib.vistaf_led_open(device.encode())
        if self._fd < 0:
            raise RuntimeError(f"cannot open LED serial device {device} (rc={self._fd})")

    def on(self) -> None:
        self._lib.vistaf_led_command(self._fd, b"on")

    def off(self) -> None:
        self._lib.vistaf_led_command(self._fd, b"off")

    def close(self) -> None:
        if self._fd >= 0:
            self._lib.vistaf_led_close(self._fd)
            self._fd = -1

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# ---------------------------------------------------------------------------
# camera_config.gpfl parsing (guvcview V4L2 control dump)
# ---------------------------------------------------------------------------

_GPFL_RE = re.compile(r"ID\{(0x[0-9a-fA-F]+)\};CHK\{[^}]*\}=VAL\{(-?\d+)\}")


def parse_gpfl(path: str) -> List[Tuple[int, int]]:
    """(control_id, value) pairs from a guvcview .gpfl profile
    (``camera_config.gpfl``)."""
    out = []
    with open(path, "r", encoding="utf-8", errors="replace") as f:
        for line in f:
            m = _GPFL_RE.search(line)
            if m:
                out.append((int(m.group(1), 16), int(m.group(2))))
    return out
