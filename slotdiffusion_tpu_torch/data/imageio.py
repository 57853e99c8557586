"""Image files without an image library: what the readers of the port need
from PIL, computed as PIL computes it, on numpy, the standard library's
`zlib` and `struct`, and the port's native library (`csrc/imageio.cpp`,
bound in `data/fastio.py`).

- `read_image(path, truncated_ok)`: a PNG or JPEG file -> `Image`, the
  mode and pixels `PIL.Image.open` gives (`np.asarray` of it):
  - PNG: 1-, 2-, 4-, 8- and 16-bit gray ("1", "L", "I;16"), RGB, RGBA,
    gray + alpha ("LA"; at 16 bits "RGBA", as PIL reads it) and palette
    ("P", indices kept, the PLTE beside them), plain or Adam7-interlaced;
    16-bit colour keeps the high byte, as PIL does;
  - JPEG: sequential or progressive, Huffman- or arithmetic-coded,
    decoded as libjpeg-turbo decodes ("L", "RGB", and "CMYK" as PIL's
    inverted raw mode).
  A file whose data ends early raises OSError("image file is truncated")
  unless `truncated_ok`, PIL's `ImageFile.LOAD_TRUNCATED_IMAGES`; then a
  PNG keeps its whole rows (zeros after them) as PIL does, and a JPEG
  decodes as libjpeg decodes a stream that ends early.
- `Image.convert("RGB" | "L")`: PIL's fixed-point conversions
  (L = (19595 R + 38470 G + 7471 B + 2^15) >> 16, CMYK -> RGB as
  Pillow's cmyk2rgb, a palette's missing entries gray, "I;16" clipped at
  255);
- `resize_bilinear` and `resize_nearest`: `Image.resize` with BILINEAR
  (uint8, any number of channels) and NEAREST (1-, 2- or 4-byte pixels:
  uint8 "L"/"P", int32 "I", uint8 RGB), bit for bit; `resize_to_cover`,
  COCO's and VOC's resize to a size that covers the resolution;
- `crop` and `flip_left_right`: `Image.crop` (zeros outside the image)
  and `Image.transpose(FLIP_LEFT_RIGHT)`;
- `polygon_mask`: `ImageDraw.polygon(xy, fill=1, outline=1)` on a
  mode-"1" image, polygons painted in turn.
"""

import ctypes
import struct
import zlib
from dataclasses import dataclass

import numpy as np

from . import fastio
from .fastio import ptr

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# libjpeg's colour spaces (imageio_jpeg_info) -> PIL's mode
_JPEG_MODES = {0: "L", 1: "RGB", 2: "RGB", 3: "CMYK", 4: "CMYK"}
_CHANNELS = {"1": 1, "L": 1, "P": 1, "I;16": 1, "LA": 2, "RGB": 3,
             "RGBA": 4, "CMYK": 4}
_TRUNCATED = "image file is truncated"


@dataclass
class Image:
    """A decoded image: its PIL mode, its pixels as `np.asarray(pil_image)`
    gives them ([H, W] or [H, W, C]), a "P" image's palette (uint8 [256,
    3], entries the file lacks gray as PIL fills them), and whether the
    file's data ended early."""
    mode: str
    array: np.ndarray
    palette: np.ndarray = None
    truncated: bool = False
    bit_depth: int = 8

    def convert(self, mode):
        """-> Image in `mode` ("RGB" or "L"), as `PIL.Image.convert`."""
        if mode == self.mode:
            return Image(mode, self.array.copy())
        a = self.array
        if self.mode == "1":
            a = a.astype(np.uint8) * 255
            src = "L"
        elif self.mode == "P":
            a = self.palette[a]
            src = "RGB"
        elif self.mode == "LA":
            a = a[..., 0]
            src = "L"
        elif self.mode == "RGBA":
            a = a[..., :3]
            src = "RGB"
        elif self.mode == "CMYK":
            a = cmyk_to_rgb(a)
            src = "RGB"
        elif self.mode == "I;16":  # Pillow's I16_L: clipped at 255
            a = np.minimum(a, 255).astype(np.uint8)
            src = "L"
        else:
            src = self.mode
        if src == mode:
            return Image(mode, np.ascontiguousarray(a))
        if (src, mode) == ("L", "RGB"):
            return Image(mode, np.repeat(a[..., None], 3, axis=2))
        if (src, mode) == ("RGB", "L"):
            return Image(mode, rgb_to_l(a))
        raise ValueError(f"no conversion from {self.mode} to {mode}")


def rgb_to_l(rgb):
    """uint8 [..., 3] -> uint8 [...]: Pillow's L24 fixed point."""
    r = rgb.astype(np.uint32)
    return ((r[..., 0] * 19595 + r[..., 1] * 38470 + r[..., 2] * 7471 +
             0x8000) >> 16).astype(np.uint8)


def cmyk_to_rgb(cmyk):
    """uint8 [..., 4] -> uint8 [..., 3]: Pillow's cmyk2rgb."""
    c = cmyk.astype(np.int32)
    nk = 255 - c[..., 3:4]
    t = c[..., :3] * nk + 128
    return np.clip(nk - (((t >> 8) + t) >> 8), 0, 255).astype(np.uint8)


# ---- PNG --------------------------------------------------------------

def _png_chunks(data, name):
    """-> [(type, payload)] up to IEND or the end of the data; a chunk cut
    short keeps what is there. CRCs are not checked (PIL does not check
    the image data's)."""
    if data[:8] != PNG_SIGNATURE:
        raise OSError(f"cannot identify image file {name!r}")
    chunks, pos = [], 8
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        chunks.append((kind, body))
        if kind == b"IEND" or len(body) < n:
            break
        pos += 12 + n
    return chunks


def png_opens(data):
    """Whether PIL's `Image.open` takes these PNG bytes: the signature, and
    every chunk before the first IDAT whole, with that IDAT's length and
    type (where `open` stops reading; the image data is read later, at
    the decode)."""
    if data[:8] != PNG_SIGNATURE:
        return False
    pos = 8
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        if kind == b"IDAT":
            return True
        pos += 12 + n
    return False


# Adam7: (first column, first row, column step, row step) of each pass
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _unfilter(raw, off, rows, W, channels, depth, name):
    """`rows` filtered rows of a W-pixel-wide (sub)image from raw[off:] ->
    their samples: uint8 [rows, W * channels] (one value a sample, bits
    unpacked) or, at 16 bits, uint8 [rows, W * channels * 2] (big-endian
    pairs)."""
    rowbytes = (W * channels * depth + 7) // 8
    plain = np.zeros((rows, rowbytes), np.uint8)
    if rows:
        filtered = np.frombuffer(raw, np.uint8, rows * (rowbytes + 1), off)
        bad = fastio.lib().imageio_png_unfilter(
            ptr(np.ascontiguousarray(filtered)), rows, rowbytes,
            max(1, channels * depth // 8), ptr(plain))
        if bad:
            raise OSError(f"{name}: unknown PNG filter type in row {bad}")
    if depth < 8:
        bits = np.unpackbits(plain, axis=1).reshape(
            rows, rowbytes * 8 // depth, depth)
        vals = np.zeros(bits.shape[:2], np.uint8)
        for b in range(depth):
            vals = (vals << 1) | bits[..., b]
        plain = vals[:, :W * channels]
    return plain


def decode_png(data, truncated_ok=False, name="<bytes>"):
    """The bytes of a PNG file -> Image (see the module docstring)."""
    chunks = _png_chunks(data, name)
    if not chunks or chunks[0][0] != b"IHDR" or len(chunks[0][1]) < 13:
        raise OSError(f"{name}: a PNG file must start with its IHDR")
    W, H, depth, ctype, _, _, interlace = struct.unpack(
        ">IIBBBBB", chunks[0][1][:13])
    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}.get(ctype)
    if channels is None or depth not in (1, 2, 4, 8, 16) or (
            ctype != 0 and depth < 8 and ctype != 3) or (
            ctype == 3 and depth == 16) or interlace > 1:
        raise OSError(f"{name}: PNG colour type {ctype} at {depth} bits "
                      f"(interlace {interlace}) is not supported")
    palette = None
    idat = []
    for kind, body in chunks[1:]:
        if kind == b"PLTE":
            n = len(body) // 3
            palette = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3,
                                axis=1)
            palette[:n] = np.frombuffer(body[:3 * n], np.uint8).reshape(n, 3)
        elif kind == b"IDAT":
            idat.append(body)
    if ctype == 3 and palette is None:
        raise OSError(f"{name}: a palette PNG without PLTE")
    try:
        raw = zlib.decompressobj().decompress(b"".join(idat))
    except zlib.error as e:
        raise OSError(f"{name}: broken PNG data ({e})") from e
    width = W * channels * (2 if depth == 16 else 1)  # samples a row
    if not interlace:
        rows = min(H, len(raw) // ((W * channels * depth + 7) // 8 + 1))
        truncated = rows < H
        plain = np.zeros((H, width), np.uint8)
        plain[:rows] = _unfilter(raw, 0, rows, W, channels, depth, name)
    else:
        # each pass a small image of its own, filtered on its own; a pass
        # cut short keeps its whole rows, the rest of the image zeros
        plain = np.zeros((H, W, width // W), np.uint8)
        off, truncated = 0, False
        for x0, y0, dx, dy in ADAM7:
            pw, ph = -(-(W - x0) // dx), -(-(H - y0) // dy)
            if pw <= 0 or ph <= 0:
                continue
            rowbytes = (pw * channels * depth + 7) // 8
            rows = min(ph, (len(raw) - off) // (rowbytes + 1))
            sub = _unfilter(raw, off, rows, pw, channels, depth, name)
            plain[y0:y0 + rows * dy:dy, x0::dx] = sub.reshape(
                rows, pw, width // W)
            off += rows * (rowbytes + 1)
            if rows < ph:
                truncated = True
                break
        plain = plain.reshape(H, width)
    if truncated and not truncated_ok:
        raise OSError(f"{_TRUNCATED} ({name})")
    if depth == 16:
        plain = plain.reshape(H, W * channels, 2)
        if ctype == 0:
            return Image("I;16", (plain[..., 0].astype(np.uint16) << 8) |
                         plain[..., 1], truncated=truncated, bit_depth=16)
        plain = plain[..., 0]  # PIL keeps the high byte of 16-bit colour
        if ctype == 4:  # and reads 16-bit gray + alpha as RGBA
            la = plain.reshape(H, W, 2)
            return Image("RGBA", np.ascontiguousarray(
                la[..., [0, 0, 0, 1]]), truncated=truncated, bit_depth=16)
    elif depth < 8:
        if ctype == 0 and depth == 1:
            return Image("1", plain.astype(bool), truncated=truncated,
                         bit_depth=1)
        if ctype == 0:
            plain = plain * np.uint8(255 // (2 ** depth - 1))
    mode = {0: "L", 2: "RGB", 3: "P", 4: "LA", 6: "RGBA"}[ctype]
    arr = plain.reshape(H, W, channels)
    if channels == 1:
        arr = arr[..., 0]
    return Image(mode, np.ascontiguousarray(arr), palette=palette,
                 truncated=truncated, bit_depth=depth)


# ---- JPEG -------------------------------------------------------------

def jpeg_info(data, name="<bytes>"):
    """-> (H, W, components, libjpeg colour space: 0 gray, 1 YCbCr, 2 RGB,
    3 CMYK, 4 YCCK)."""
    dims = np.zeros(4, np.int32)
    err = ctypes.create_string_buffer(fastio.ERR_LEN)
    if fastio.lib().imageio_jpeg_info(data, len(data), ptr(dims, fastio._i32p),
                                      err, fastio.ERR_LEN):
        raise OSError(f"{name}: {err.value.decode()}")
    return tuple(int(d) for d in dims)


def decode_jpeg(data, truncated_ok=False, name="<bytes>"):
    """The bytes of a JPEG file -> Image ("L", "RGB" or "CMYK")."""
    H, W, _, space = jpeg_info(data, name)
    mode = _JPEG_MODES[space]
    shape = (H, W) if mode == "L" else (H, W, _CHANNELS[mode])
    out = np.empty(shape, np.uint8)
    status = np.zeros(1, np.int32)
    err = ctypes.create_string_buffer(fastio.ERR_LEN)
    if fastio.lib().imageio_jpeg_decode(
            data, len(data), ptr(out), out.size,
            ptr(status, fastio._i32p), err, fastio.ERR_LEN):
        raise OSError(f"{name}: {err.value.decode()}")
    if status[0] and not truncated_ok:
        raise OSError(f"{_TRUNCATED} ({name})")
    return Image(mode, out, truncated=bool(status[0]))


def read_image(path, truncated_ok=False):
    """A PNG or JPEG file -> Image, told apart by their signatures.
    FileNotFoundError for a missing file, OSError for one that does not
    decode."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] == PNG_SIGNATURE:
        return decode_png(data, truncated_ok, path)
    if data[:2] == b"\xff\xd8":
        return decode_jpeg(data, truncated_ok, path)
    raise OSError(f"cannot identify image file {path!r}")


# ---- geometry ---------------------------------------------------------

def resize_bilinear(arr, size):
    """uint8 [H, W] or [H, W, C] -> the same at `size` (h, w), as
    `Image.resize((w, h), BILINEAR)`."""
    arr = np.ascontiguousarray(arr, np.uint8)
    h, w = size
    if arr.shape[:2] == (h, w):
        return arr.copy()
    c = 1 if arr.ndim == 2 else arr.shape[2]
    out = np.empty((h, w) + arr.shape[2:], np.uint8)
    if fastio.lib().imageio_resize_bilinear_u8(
            ptr(arr), arr.shape[0], arr.shape[1], c, ptr(out), h, w):
        raise ValueError(f"cannot resize {arr.shape} to {size}")
    return out


def resize_nearest(arr, size):
    """[H, W] (uint8, int32, ...) or [H, W, C] uint8 -> the same at `size`
    (h, w), as `Image.resize((w, h), NEAREST)`."""
    arr = np.ascontiguousarray(arr)
    h, w = size
    if arr.shape[:2] == (h, w):
        return arr.copy()
    elem = arr.itemsize * (1 if arr.ndim == 2 else arr.shape[2])
    out = np.empty((h, w) + arr.shape[2:], arr.dtype)
    if fastio.lib().imageio_resize_nearest(
            ptr(arr), arr.shape[0], arr.shape[1], elem, ptr(out), h, w):
        raise ValueError(f"cannot resize {arr.shape} to {size}")
    return out


def resize_to_cover(arr, res, nearest=False):
    """Resize so the image covers `res` (H, W), keeping its aspect: the
    size COCO's and VOC's readers take, round(side * scale) with the
    larger of the two scales, NEAREST or BILINEAR."""
    H, W = arr.shape[:2]
    scale = max(res[0] / H, res[1] / W)
    size = (int(round(H * scale)), int(round(W * scale)))
    return resize_nearest(arr, size) if nearest else \
        resize_bilinear(arr, size)


def crop(arr, box):
    """`Image.crop(box)` with box = (left, top, right, bottom): pixels
    outside the image are zeros."""
    left, top, right, bottom = (int(v) for v in box)
    out = np.zeros((bottom - top, right - left) + arr.shape[2:], arr.dtype)
    H, W = arr.shape[:2]
    y0, y1 = max(top, 0), min(bottom, H)
    x0, x1 = max(left, 0), min(right, W)
    if y1 > y0 and x1 > x0:
        out[y0 - top:y1 - top, x0 - left:x1 - left] = arr[y0:y1, x0:x1]
    return out


def flip_left_right(arr):
    return np.ascontiguousarray(arr[:, ::-1])


def polygon_mask(polys, size):
    """Polygons [[x1, y1, x2, y2, ...], ...] -> uint8 [H, W] of their union,
    each filled as `ImageDraw.polygon(xy, fill=1, outline=1)` fills it on a
    mode-"1" image (vertices truncated toward zero, as Pillow takes them;
    fewer than three vertices draw nothing)."""
    h, w = size
    out = np.zeros((h, w), np.uint8)
    for poly in polys:
        xy = [int(float(v)) for v in poly[:len(poly) // 2 * 2]]
        if len(xy) < 6:
            continue
        pts = np.asarray(xy, np.int32)
        fastio.lib().imageio_polygon_fill(ptr(out), h, w,
                                          ptr(pts, fastio._i32p),
                                          len(xy) // 2)
    return out
