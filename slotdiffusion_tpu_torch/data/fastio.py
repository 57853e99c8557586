"""ctypes bindings of the native decode path of the input pipeline (an own
copy of the JAX package's data/fastio.py:30-166): `native/fastio.cpp`,
compiled with `g++` at first use into `slotdiffusion_tpu_torch/_build/`
(never into `native/`).

- `decode_jpeg_norm(path, res)`: JPEG decode -> bilinear resize -> [-1, 1]
  in one C call, float32 [h, w, 3];
- `decode_png_mask(path, res)`: a grayscale id-mask PNG, nearest-resized,
  uint8 [h, w]; None for an RGB or palette PNG.

Both return None when the library cannot be built (no g++, libjpeg or
libpng) or a decode fails, and the caller decodes with PIL instead: this
is a host decode path, not a device kernel.
"""

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SOURCE = os.path.join(_REPO, "native", "fastio.cpp")
BUILD_ROOT = os.path.join(_REPO, "slotdiffusion_tpu_torch", "_build")
# native/Makefile's flags
CXX_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17", "-Wall"]
LIBS = ["-ljpeg", "-lpng"]
_lock = threading.Lock()
_lib = None
_tried = False


def _build():
    """Compile the source into a library keyed by its hash; -> its
    path."""
    with open(SOURCE, "rb") as f:
        tag = hashlib.sha256(f.read() + " ".join(CXX_FLAGS).encode()
                             ).hexdigest()[:16]
    out_dir = os.path.join(BUILD_ROOT, f"fastio-{tag}")
    path = os.path.join(out_dir, "libfastio.so")
    if not os.path.isfile(path):
        os.makedirs(out_dir, exist_ok=True)
        tmp = f"{path}.tmp{os.getpid()}"
        subprocess.run(["g++", *CXX_FLAGS, "-o", tmp, SOURCE, *LIBS],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, path)
    return path


def _load():
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        try:
            lib = ctypes.CDLL(_build())
        except (OSError, subprocess.SubprocessError):
            return None
        lib.fastio_decode_jpeg_resize_norm.restype = ctypes.c_int
        lib.fastio_decode_jpeg_resize_norm.argtypes = [
            ctypes.c_char_p, ctypes.c_long, ctypes.POINTER(ctypes.c_float),
            ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float]
        lib.fastio_decode_png_resize_nearest_u8.restype = ctypes.c_int
        lib.fastio_decode_png_resize_nearest_u8.argtypes = [
            ctypes.c_char_p, ctypes.c_long, ctypes.c_char_p, ctypes.c_int,
            ctypes.c_int]
        _lib = lib
        return _lib


def fastio_available():
    return _load() is not None


def _read(path):
    try:
        with open(path, "rb") as f:
            return f.read()
    except OSError:
        return None


def decode_jpeg_norm(path, res):
    """JPEG file -> float32 [h, w, 3] in [-1, 1], or None."""
    lib = _load()
    buf = None if lib is None else _read(path)
    if buf is None:
        return None
    h, w = res
    out = np.empty((h, w, 3), np.float32)
    rc = lib.fastio_decode_jpeg_resize_norm(
        buf, len(buf), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        h, w, 1.0 / 127.5, -1.0)
    return out if rc == 0 else None


def decode_png_mask(path, res):
    """Grayscale id-mask PNG -> uint8 [h, w], nearest-resized, or None."""
    lib = _load()
    buf = None if lib is None else _read(path)
    if buf is None:
        return None
    h, w = res
    out = np.empty((h, w), np.uint8)
    rc = lib.fastio_decode_png_resize_nearest_u8(
        buf, len(buf), out.ctypes.data_as(ctypes.c_char_p), h, w)
    return out if rc == 0 else None
