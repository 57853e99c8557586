"""Write an Adam7-interlaced PNG (PIL writes none): each pass's rows with
filter type 0, deflated together. For the port's decoder tests and its
file tree (scripts/make_torch_data_fixture.py).

    from png_adam7 import encode_png_adam7
    data = encode_png_adam7(pixels, depth=8, ctype=0, palette=None)

pixels: integer [H, W] or [H, W, C] of sample values (below 2**depth);
ctype: PNG colour type (0 gray, 2 RGB, 3 palette, 4 gray + alpha, 6
RGBA); palette: uint8 [n, 3] for ctype 3; trns: the tRNS chunk's bytes.
"""

import struct
import zlib

import numpy as np

ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _chunk(kind, body):
    return (struct.pack(">I", len(body)) + kind + body +
            struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def _row(samples, depth):
    """One row of sample values -> its bytes."""
    if depth == 16:
        return samples.astype(">u2").tobytes()
    if depth == 8:
        return samples.astype(np.uint8).tobytes()
    bits = ((samples[:, None].astype(np.uint8) >> np.arange(
        depth - 1, -1, -1, dtype=np.uint8)) & 1).ravel()
    return np.packbits(bits).tobytes()


def encode_png_adam7(pixels, depth=8, ctype=0, palette=None, trns=None):
    px = np.asarray(pixels)
    H, W = px.shape[:2]
    px = px.reshape(H, W, -1)
    raw = b""
    for x0, y0, dx, dy in ADAM7:
        sub = px[y0::dy, x0::dx]
        if sub.shape[0] == 0 or sub.shape[1] == 0:
            continue
        for r in sub:
            raw += b"\x00" + _row(r.ravel(), depth)
    out = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(
        ">IIBBBBB", W, H, depth, ctype, 0, 0, 1))
    if palette is not None:
        out += _chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    if trns is not None:
        out += _chunk(b"tRNS", trns)
    return out + _chunk(b"IDAT", zlib.compress(raw)) + _chunk(b"IEND", b"")
