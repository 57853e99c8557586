"""PNG and animated PNG (APNG) files of the port, written and read with
`zlib` and `struct` alone: the port imports neither PIL nor imageio.
`save_image` writes a frame as a PNG (the JAX package's
`save_image`, lossless); `save_video` writes frames as an APNG where the
JAX package writes an mp4 (or a GIF): lossless, and any PNG reader shows
its first frame. The reader reads what the writer writes (8-bit
grey, RGB or RGBA, not interlaced, filter type 0).
"""

import os
import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_COLOR_TYPES = {1: 0, 3: 2, 4: 6}  # channels -> PNG colour type
_CHANNELS = {v: k for k, v in _COLOR_TYPES.items()}


def to_uint8(img):
    """A uint8 array as it is; floats in [0, 1] -> clip * 255, truncated
    (the JAX package's `save_image` conversion); tensors are moved to the
    host."""
    if hasattr(img, "detach"):
        img = img.detach().cpu().numpy()
    img = np.asarray(img)
    if img.dtype != np.uint8:
        img = (np.clip(img, 0.0, 1.0) * 255.0).astype(np.uint8)
    return img


def _chunk(kind, data):
    return (struct.pack(">I", len(data)) + kind + data +
            struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def _header(frame):
    if frame.ndim == 2:
        frame = frame[..., None]
    H, W, C = frame.shape
    if C not in _COLOR_TYPES:
        raise ValueError(f"a PNG frame takes 1, 3 or 4 channels, not {C}")
    return frame, _chunk(b"IHDR", struct.pack(
        ">IIBBBBB", W, H, 8, _COLOR_TYPES[C], 0, 0, 0))


def _pixels(frame, level):
    """zlib stream of the rows, each after a filter-type byte 0."""
    H = frame.shape[0]
    rows = np.concatenate([np.zeros((H, 1), np.uint8),
                           frame.reshape(H, -1)], axis=1)
    return zlib.compress(rows.tobytes(), level)


def encode_png(img, level=6):
    """uint8 [H, W] or [H, W, C] (C in 1, 3, 4) -> the bytes of a PNG."""
    frame, ihdr = _header(np.ascontiguousarray(to_uint8(img)))
    return (_SIGNATURE + ihdr + _chunk(b"IDAT", _pixels(frame, level)) +
            _chunk(b"IEND", b""))


def encode_apng(frames, fps=8, level=6):
    """uint8 [T, H, W(, C)] -> the bytes of an APNG that plays the frames
    at `fps`, looping."""
    frames = [np.ascontiguousarray(f) for f in to_uint8(frames)]
    if not frames:
        raise ValueError("an APNG needs at least one frame")
    first, ihdr = _header(frames[0])
    H, W = first.shape[:2]
    out = [_SIGNATURE, ihdr,
           _chunk(b"acTL", struct.pack(">II", len(frames), 0))]
    seq = 0
    for i, frame in enumerate(frames):
        frame = _header(frame)[0]
        if frame.shape != first.shape:
            raise ValueError("every frame of an APNG has one shape")
        out.append(_chunk(b"fcTL", struct.pack(
            ">IIIIIHHBB", seq, W, H, 0, 0, 1, max(int(fps), 1), 0, 0)))
        seq += 1
        data = _pixels(frame, level)
        if i == 0:
            out.append(_chunk(b"IDAT", data))
        else:
            out.append(_chunk(b"fdAT", struct.pack(">I", seq) + data))
            seq += 1
    out.append(_chunk(b"IEND", b""))
    return b"".join(out)


def _write(data, path):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(data)
    return path


def save_image(img, path):
    """Write [H, W, 3] (uint8, or floats in [0, 1]) as a PNG at `path`."""
    return _write(encode_png(img), path)


def save_video(frames, path, fps=8):
    """Write [T, H, W, 3] (uint8, or floats in [0, 1]) as an APNG; the
    file is `path` with its extension made `.apng`. -> the path
    written."""
    path = os.path.splitext(path)[0] + ".apng"
    return _write(encode_apng(frames, fps), path)


def _chunks(data):
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    pos = 8
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        crc = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])[0]
        if zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"bad CRC in a {kind!r} chunk")
        yield kind, body
        pos += 12 + n


def decode_png(data):
    """The bytes of a PNG or APNG this module wrote -> uint8 [T, H, W, C]
    (T = 1 for a still PNG), and the APNG's frames a second (None for a
    still PNG)."""
    streams, current, fps = [], None, None
    H = W = C = None
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            W, H, depth, ctype, _, filt, lace = struct.unpack(">IIBBBBB",
                                                              body)
            if depth != 8 or ctype not in _CHANNELS or lace or filt:
                raise ValueError("the reader takes 8-bit grey, RGB or RGBA"
                                 ", not interlaced")
            C = _CHANNELS[ctype]
        elif kind == b"fcTL":
            num, den = struct.unpack(">HH", body[20:24])
            fps = (den or 100) / max(num, 1)
            current = []
            streams.append(current)
        elif kind in (b"IDAT", b"fdAT"):
            if current is None:  # a still PNG: one stream, no fcTL
                current = []
                streams.append(current)
            current.append(body if kind == b"IDAT" else body[4:])
    frames = []
    for parts in streams:
        raw = np.frombuffer(zlib.decompress(b"".join(parts)), np.uint8)
        rows = raw.reshape(H, 1 + W * C)
        if rows[:, 0].any():
            raise ValueError("the reader takes filter type 0 alone")
        frames.append(rows[:, 1:].reshape(H, W, C))
    return np.stack(frames), fps


def read_png(path):
    """A PNG or APNG file this module wrote -> (uint8 [T, H, W, C], frames
    a second or None)."""
    with open(path, "rb") as f:
        return decode_png(f.read())
