"""ctypes bindings of the port's native decode library,
`slotdiffusion_tpu_torch/csrc/imageio.cpp`, compiled with `g++` (the C++
standard library alone: no libjpeg, libpng or zlib) at first use into
`slotdiffusion_tpu_torch/_build/`.

The JAX package's native entry points (its data/fastio.py:30-166), on the
port's own decoder:
- `decode_jpeg_norm(path, res)`: JPEG decode -> the JAX native path's
  float bilinear resize -> [-1, 1], float32 [h, w, 3]; None for a CMYK or
  YCCK JPEG, which that path cannot decode (the JAX reader then takes
  PIL's arithmetic: `transforms.BaseTransforms.load_image` does too);
- `decode_png_mask(path, res)`: a grayscale id-mask PNG (any bit depth,
  tRNS too) read and nearest-resized as the JAX native path (libpng's
  simplified API) reads and resizes it, uint8 [h, w]; None for a PNG of
  another colour type or one whose data ends early, which the JAX native
  path refuses.

`lib()` returns the loaded library for `data/imageio.py`. A build that
fails raises `NativeLibraryError` with the compiler's message: the port has
no other decoder to fall back to.
"""

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "imageio.cpp")
BUILD_ROOT = os.path.join(_PKG, "_build")
CXX = "g++"
CXX_FLAGS = ["-O2", "-fPIC", "-shared", "-std=c++17", "-Wall"]
ERR_LEN = 256
_lock = threading.Lock()
_lib = None

_P = ctypes.POINTER
_u8p, _f32p, _i32p = (_P(ctypes.c_uint8), _P(ctypes.c_float),
                      _P(ctypes.c_int))
_SIGNATURES = {
    "imageio_jpeg_info": [ctypes.c_char_p, ctypes.c_long, _i32p,
                          ctypes.c_char_p, ctypes.c_int],
    "imageio_jpeg_decode": [ctypes.c_char_p, ctypes.c_long, _u8p,
                            ctypes.c_long, _i32p, ctypes.c_char_p,
                            ctypes.c_int],
    "imageio_jpeg_resize_norm": [ctypes.c_char_p, ctypes.c_long, _f32p,
                                 ctypes.c_int, ctypes.c_int, ctypes.c_float,
                                 ctypes.c_float, _i32p, ctypes.c_char_p,
                                 ctypes.c_int],
    "imageio_nearest_fastio_u8": [_u8p, ctypes.c_int, ctypes.c_int, _u8p,
                                  ctypes.c_int, ctypes.c_int],
    "imageio_resize_bilinear_u8": [_u8p, ctypes.c_int, ctypes.c_int,
                                   ctypes.c_int, _u8p, ctypes.c_int,
                                   ctypes.c_int],
    "imageio_resize_nearest": [_u8p, ctypes.c_int, ctypes.c_int,
                               ctypes.c_int, _u8p, ctypes.c_int,
                               ctypes.c_int],
    "imageio_png_unfilter": [_u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                             _u8p],
    "imageio_polygon_fill": [_u8p, ctypes.c_int, ctypes.c_int, _i32p,
                             ctypes.c_int],
}
_VOID = ("imageio_nearest_fastio_u8",)


class NativeLibraryError(RuntimeError):
    """The native decode library did not build or load."""


def _build():
    """Compile the source into a library keyed by its hash; -> its
    path."""
    with open(SOURCE, "rb") as f:
        tag = hashlib.sha256(f.read() + " ".join([CXX, *CXX_FLAGS]).encode()
                             ).hexdigest()[:16]
    out_dir = os.path.join(BUILD_ROOT, f"imageio-{tag}")
    path = os.path.join(out_dir, "libimageio.so")
    if os.path.isfile(path):
        return path
    os.makedirs(out_dir, exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}"
    try:
        proc = subprocess.run([CXX, *CXX_FLAGS, "-o", tmp, SOURCE],
                              capture_output=True, text=True, timeout=300)
    except FileNotFoundError as e:
        raise NativeLibraryError(
            f"the C++ compiler {CXX!r} is not installed, so "
            f"{os.path.relpath(SOURCE, _PKG)} cannot be built") from e
    if proc.returncode:
        raise NativeLibraryError(
            f"{CXX} failed to build {SOURCE}:\n{proc.stderr.strip()}")
    os.replace(tmp, path)
    return path


def lib():
    """The loaded library (built on first use); NativeLibraryError if it
    cannot be built or loaded."""
    global _lib
    with _lock:
        if _lib is None:
            path = _build()
            try:
                handle = ctypes.CDLL(path)
            except OSError as e:
                raise NativeLibraryError(f"cannot load {path}: {e}") from e
            for name, args in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = args
                fn.restype = None if name in _VOID else ctypes.c_int
            _lib = handle
        return _lib


def fastio_available():
    """True once the library is built and loaded (NativeLibraryError
    otherwise)."""
    return lib() is not None


def ptr(arr, kind=_u8p):
    return arr.ctypes.data_as(kind)


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def decode_jpeg_norm(path, res, data=None):
    """JPEG file (or its bytes, `data`) -> float32 [h, w, 3] in [-1, 1]
    through the JAX native path's resize; None for CMYK/YCCK. A stream
    that ends early decodes as libjpeg decodes it (the missing blocks
    gray), as the JAX native path does. OSError on a file that does not
    decode."""
    buf = _read(path) if data is None else data
    h, w = res
    out = np.empty((h, w, 3), np.float32)
    status = np.zeros(1, np.int32)
    err = ctypes.create_string_buffer(ERR_LEN)
    rc = lib().imageio_jpeg_resize_norm(
        buf, len(buf), ptr(out, _f32p), h, w, 1.0 / 127.5, -1.0,
        ptr(status, _i32p), err, ERR_LEN)
    if rc == 3:
        return None
    if rc:
        raise OSError(f"{path}: {err.value.decode()}")
    return out


def _gamma_16_to_8(shift):
    """libpng's 16-to-8-bit gamma table (png.c png_build_16to8_table) for
    16-bit data the simplified API reads as linear and writes as 8-bit at
    gamma 1/2.2: uint8 [2**(16 - shift)], indexed by value >> shift."""
    size = 1 << (16 - shift)
    # the 16-bit input at each boundary between 8-bit outputs i and i + 1
    out = np.arange(255) * 257 + 128
    bound = np.floor(65535 * (out / 65535.0) ** 2.2 + 0.5).astype(np.int64)
    bound = (bound * (size - 1) + 32768) // 65535 + 1
    return np.searchsorted(bound, np.arange(size), side="right").astype(
        np.uint8)


def _png_mask_as_libpng(img, chunks):
    """A grayscale PNG's decoded samples -> uint8 [H, W] as libpng's
    simplified API reads the file into PNG_FORMAT_GRAY (the JAX package's
    native/fastio.cpp:228-260): 1-, 2- and 4-bit values expanded to 8 bits
    (1 to 255), 16-bit values through the 16-to-8 gamma table (the top
    11 bits, or the sBIT chunk's significant bits when fewer), the
    tRNS chunk's transparent value composited onto black, 0, and an Adam7
    16-bit file without tRNS in libpng's rows (`_adam7_16bit_rows`)."""
    arr = img.array
    if img.mode == "1":
        arr = arr.astype(np.uint8) * 255
    body = dict(chunks)
    trns = body.get(b"tRNS", b"")
    transparent = None
    if len(trns) >= 2:  # against the samples as stored, before expansion
        key = int.from_bytes(trns[:2], "big") & ((1 << img.bit_depth) - 1)
        stored = img.array.astype(np.uint16)
        if img.mode == "L" and img.bit_depth < 8:
            stored //= 255 // (2 ** img.bit_depth - 1)
        transparent = stored == key
    if img.bit_depth == 16:
        sig = body.get(b"sBIT", b"")[:1]
        sig = sig[0] if sig else 0
        shift = 16 - sig if 0 < sig < 16 else 0
        shift = min(max(shift, 5), 8)
        arr = _gamma_16_to_8(shift)[arr >> shift]
    arr = np.ascontiguousarray(arr, np.uint8)
    if transparent is not None:
        arr = np.where(transparent, np.uint8(0), arr)
    elif img.bit_depth == 16 and body[b"IHDR"][12]:
        arr = _adam7_16bit_rows(arr)
    return arr


def _adam7_16bit_rows(arr):
    """The rows libpng 1.6's simplified API returns for an Adam7 16-bit
    gray PNG without tRNS (with tRNS it takes another path and returns the
    file's rows): as if each row of passes 1-6 were written into row 0
    (its own columns, pass after pass) and each row r of pass 7 into rows
    r and r + 1. So every odd row is the file's, every even row r >= 2 is
    row r - 1, and column c of row 0 is the last row of the last of
    passes 1-6 that holds column c. A function of the file alone: the
    same on every height and width, in every process, whatever the output
    buffer held (tests/test_torch_imageio.py holds it against the JAX
    native path)."""
    from .imageio import ADAM7
    H = arr.shape[0]
    out = arr.copy()
    out[2::2] = arr[1:H - 1:2]
    for x0, y0, dx, dy in ADAM7[:6]:
        if y0 < H:
            out[0, x0::dx] = arr[y0 + (H - 1 - y0) // dy * dy, x0::dx]
    return out


def decode_png_mask(path, res):
    """Grayscale id-mask PNG -> uint8 [h, w], read as the JAX native path's
    libpng reads it (`_png_mask_as_libpng`: 16-bit and tRNS masks too)
    and nearest-resized as that path resizes; None for another colour
    type or a file whose image data ends early (the JAX native path's
    libpng refuses those, and its reader decodes them another way)."""
    from .imageio import _png_chunks, decode_png
    data = _read(path)
    img = decode_png(data, truncated_ok=True, name=path)
    if img.mode not in ("L", "1", "I;16") or img.truncated:
        return None
    arr = _png_mask_as_libpng(img, _png_chunks(data, path))
    h, w = res
    out = np.empty((h, w), np.uint8)
    lib().imageio_nearest_fastio_u8(ptr(arr), arr.shape[0], arr.shape[1],
                                    ptr(out), h, w)
    return out
