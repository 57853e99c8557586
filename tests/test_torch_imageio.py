"""The port's image files without PIL (`slotdiffusion_tpu_torch/data/
imageio.py` and `csrc/imageio.cpp`) against PIL 12 on this host, the
yardstick, and against the JAX package's native decode (libjpeg) for what
PIL does not do the way the JAX readers do.

Bit for bit: PNG of every colour type (written by PIL and by the port's
own `utils/png.py`), cut short or whole, and Adam7-interlaced at every bit
depth and colour type (`scripts/png_adam7.py`; PIL writes no
interlaced PNG); `convert("RGB")` and `convert("L")`; BILINEAR and
NEAREST resizes up and down (COCO's `_resize_min_shape` sizes, int32 "I"
masks); baseline and progressive JPEG in 4:4:4, 4:2:2, 4:2:0, grayscale,
CMYK and with restart intervals, and arithmetic-coded JPEG, sequential
and progressive (`scripts/arith_jpeg.c`, built with gcc
against this host's libjpeg), each against PIL and the JAX native path;
a JPEG cut short against libjpeg through the JAX native path (PIL decodes
one it is told to accept otherwise: it stops where its data stops), and
taken as truncated exactly where PIL refuses it, down to a cut in its
last bytes; the fused decode and resize of the JAX native path; grayscale
mask PNGs of every depth, with tRNS or sBIT, as libpng's simplified API
reads them. Polygons: bit for bit on convex and star shapes, annotators'
outlines, the shapes of the COCO generator and random polygons that may
cross and touch themselves, revisit a vertex and leave the image.
"""

import io
import os
import struct
import subprocess
import sys
import zlib

import numpy as np
import pytest
from PIL import Image, ImageDraw, ImageFile

from slotdiffusion_tpu.data import fastio as jax_fastio
from slotdiffusion_tpu_torch.data import fastio, imageio
from slotdiffusion_tpu_torch.data.transforms import BaseTransforms
from slotdiffusion_tpu_torch.utils.png import encode_png

_SCRIPTS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scripts")
sys.path.insert(0, os.path.join(_SCRIPTS, "data_utils"))
sys.path.insert(0, _SCRIPTS)
from gen_mini_seg_data import _shape_polygon  # noqa: E402
from png_adam7 import encode_png_adam7  # noqa: E402


def _textured(r, h, w, c=3):
    """Blocks plus noise: what a photo gives the entropy coder."""
    base = np.kron(r.rand(h // 8 + 2, w // 8 + 2, c), np.ones((8, 8, 1)))
    img = base[:h, :w] * 200 + r.rand(h, w, c) * 55
    return img.clip(0, 255).astype(np.uint8)


def _save(img, fmt, **kw):
    b = io.BytesIO()
    img.save(b, fmt, **kw)
    return b.getvalue()


@pytest.fixture
def strict_pil(monkeypatch):
    """PIL as a reader that sets no truncation flag (the JAX MOVi and
    Physion modules set it for the whole process)."""
    monkeypatch.setattr(ImageFile, "LOAD_TRUNCATED_IMAGES", False)


# ---- JPEG ----------------------------------------------------------------

JPEG_LAYOUTS = {
    "444": dict(subsampling=0), "422": dict(subsampling=1),
    "420": dict(subsampling=2), "gray": dict(mode="L"),
    "420_q50_odd": dict(subsampling=2, quality=50, size=(37, 53)),
    "444_tiny": dict(subsampling=0, size=(3, 5)),
    "restart_blocks": dict(subsampling=2, restart_marker_blocks=3),
    "restart_rows": dict(subsampling=0, restart_marker_rows=1),
    "cmyk": dict(mode="CMYK"),
    "celeba_size": dict(subsampling=2, size=(218, 178)),
}


def _jpeg(name, seed=0, **extra):
    kw = dict(JPEG_LAYOUTS[name], **extra)
    h, w = kw.pop("size", (64, 96))
    mode = kw.pop("mode", "RGB")
    kw.setdefault("quality", 90)
    img = _textured(np.random.RandomState(seed), h, w, 4 if mode == "CMYK"
                    else 3)
    pil = Image.fromarray(img, "CMYK") if mode == "CMYK" else \
        Image.fromarray(img).convert(mode)
    return _save(pil, "JPEG", **kw)


@pytest.mark.parametrize("layout", sorted(JPEG_LAYOUTS))
def test_jpeg_decodes_as_pil(layout):
    data = _jpeg(layout)
    if layout.startswith("restart"):
        assert b"\xff\xdd" in data
    ref = Image.open(io.BytesIO(data))
    got = imageio.decode_jpeg(data)
    assert got.mode == ref.mode
    np.testing.assert_array_equal(got.array, np.asarray(ref))
    np.testing.assert_array_equal(got.convert("RGB").array,
                                  np.asarray(ref.convert("RGB")))


@pytest.mark.parametrize("keep", [0.3, 0.5, 0.7, 0.9])
@pytest.mark.parametrize("layout", ["444", "420", "gray", "restart_blocks"])
def test_truncated_jpeg_decodes_as_libjpeg(tmp_path, layout, keep,
                                           strict_pil):
    """Cut short: the JAX native path (libjpeg from memory) decodes the
    rest as missing bits and gray blocks, and the port gives its bits; a
    reader without PIL's truncation flag refuses the file, as PIL does."""
    if not jax_fastio.fastio_available():
        pytest.skip("the JAX package's native decode does not build here")
    data = _jpeg(layout)
    path = str(tmp_path / "cut.jpg")
    with open(path, "wb") as f:
        f.write(data[:int(len(data) * keep)])
    ref = jax_fastio.decode_jpeg_norm(path, (64, 96))
    got = fastio.decode_jpeg_norm(path, (64, 96))
    np.testing.assert_array_equal(got, ref)
    assert imageio.decode_jpeg(open(path, "rb").read(),
                               truncated_ok=True).truncated
    with pytest.raises(OSError, match="truncated"):
        Image.open(path).load()
    with pytest.raises(OSError, match="truncated"):
        imageio.read_image(path)


@pytest.mark.parametrize("size", [(128, 128), (64, 64), (96, 72), (45, 50),
                                  (200, 150)])
@pytest.mark.parametrize("layout", ["420", "422", "gray"])
def test_fused_decode_resize_is_the_jax_native_path(tmp_path, layout, size):
    if not jax_fastio.fastio_available():
        pytest.skip("the JAX package's native decode does not build here")
    path = str(tmp_path / "f.jpg")
    with open(path, "wb") as f:
        f.write(_jpeg(layout, seed=1))
    np.testing.assert_array_equal(fastio.decode_jpeg_norm(path, size),
                                  jax_fastio.decode_jpeg_norm(path, size))


def _sof(data):
    """The JPEG's SOF marker code."""
    pos = 2
    while True:
        while data[pos] != 0xFF:
            pos += 1
        while data[pos] == 0xFF:
            pos += 1
        m, n = data[pos], struct.unpack(">H", data[pos + 1:pos + 3])[0]
        if 0xC0 <= m <= 0xCF and m not in (0xC4, 0xC8, 0xCC):
            return m
        pos += 1 + n


def _as_pil_and_native(data, tmp_path):
    """The port's decode of `data` against PIL's, and its fused native
    path against the JAX package's (YCbCr and gray files) at the image's
    size and at 64 x 48."""
    ref = Image.open(io.BytesIO(data))
    got = imageio.decode_jpeg(data)
    assert got.mode == ref.mode
    np.testing.assert_array_equal(got.array, np.asarray(ref))
    if got.mode == "CMYK" or not jax_fastio.fastio_available():
        return
    path = str(tmp_path / "f.jpg")
    with open(path, "wb") as f:
        f.write(data)
    for size in [got.array.shape[:2], (64, 48)]:
        np.testing.assert_array_equal(fastio.decode_jpeg_norm(path, size),
                                      jax_fastio.decode_jpeg_norm(path,
                                                                  size))


@pytest.mark.parametrize("layout", sorted(JPEG_LAYOUTS))
def test_progressive_jpeg_decodes_as_pil_and_libjpeg(tmp_path, layout):
    """Spectral selection and successive approximation (PIL's progression:
    DC first and refine scans, AC first and refine scans with EOB runs),
    with restart intervals and every subsampling."""
    data = _jpeg(layout, seed=3, progressive=True)
    assert _sof(data) == 0xC2
    _as_pil_and_native(data, tmp_path)


@pytest.fixture(scope="module")
def arith_jpeg(tmp_path_factory):
    """scripts/arith_jpeg.c built against this host's libjpeg
    (PIL writes no arithmetic-coded JPEG)."""
    exe = str(tmp_path_factory.mktemp("arith") / "arith_jpeg")
    subprocess.run(["gcc", "-O2", "-o", exe,
                    os.path.join(_SCRIPTS, "arith_jpeg.c"), "-ljpeg"],
                   check=True, capture_output=True)
    return exe


ARITH_LAYOUTS = {  # (H, W), components, restart rows, sampling of Y
    "444": ((64, 96), 3, 0, (1, 1)), "422": ((64, 96), 3, 0, (2, 1)),
    "420": ((64, 96), 3, 0, (2, 2)), "gray": ((64, 96), 1, 0, (1, 1)),
    "420_odd_restart": ((37, 53), 3, 1, (2, 2)),
    "440_restart": ((64, 96), 3, 2, (1, 2)),
}


@pytest.mark.parametrize("progressive", [False, True],
                         ids=["sequential", "progressive"])
@pytest.mark.parametrize("layout", sorted(ARITH_LAYOUTS))
def test_arithmetic_jpeg_decodes_as_pil_and_libjpeg(tmp_path, arith_jpeg,
                                                    layout, progressive):
    """ITU T.81 SOF9 and SOF10: the arithmetic decoder with its DC and AC
    conditioning, restart intervals and every subsampling."""
    (h, w), c, rows, (hs, vs) = ARITH_LAYOUTS[layout]
    img = _textured(np.random.RandomState(h + c), h, w)[..., :c]
    data = subprocess.run(
        [arith_jpeg, str(w), str(h), str(c), "85", str(int(progressive)),
         str(rows), str(hs), str(vs)], input=np.ascontiguousarray(
            img).tobytes(), capture_output=True, check=True).stdout
    assert _sof(data) == (0xCA if progressive else 0xC9)
    _as_pil_and_native(data, tmp_path)


@pytest.mark.parametrize("keep", [0.08, 0.2, 0.35, 0.5, 0.7, 0.9])
@pytest.mark.parametrize("coding", ["huffman", "arithmetic"])
@pytest.mark.parametrize("layout", ["420", "gray", "restart_rows"])
def test_truncated_progressive_jpeg_decodes_as_libjpeg(
        tmp_path, arith_jpeg, layout, coding, keep):
    """Cut short, a progressive file decodes the scans it has, then
    libjpeg-turbo's inter-block smoothing of the coefficients the cut left
    inexact (on by default there): bit for bit against the JAX native
    path; where libjpeg fails (a table cut between scans), the port raises
    too."""
    if not jax_fastio.fastio_available():
        pytest.skip("the JAX package's native decode does not build here")
    if coding == "huffman":
        data = _jpeg(layout, seed=4, progressive=True)
    else:
        kw = JPEG_LAYOUTS[layout]
        c = 1 if kw.get("mode") == "L" else 3
        img = _textured(np.random.RandomState(4), 64, 96)[..., :c]
        data = subprocess.run(
            [arith_jpeg, "96", "64", str(c), "90", "1",
             str(kw.get("restart_marker_rows", 0)), "2", "2"],
            input=np.ascontiguousarray(img).tobytes(), capture_output=True,
            check=True).stdout
    path = str(tmp_path / "cut.jpg")
    for cut in range(int(len(data) * keep), int(len(data) * keep) + 40, 9):
        with open(path, "wb") as f:
            f.write(data[:cut])
        ref = jax_fastio.decode_jpeg_norm(path, (64, 96))
        if ref is None:
            with pytest.raises(OSError):
                fastio.decode_jpeg_norm(path, (64, 96))
            continue
        np.testing.assert_array_equal(fastio.decode_jpeg_norm(path, (64, 96)),
                                      ref, err_msg=f"cut {cut}")


@pytest.mark.parametrize("layout", sorted(JPEG_LAYOUTS))
def test_jpeg_cut_in_its_last_bytes_is_truncated_where_pil_refuses_it(
        layout, strict_pil):
    """Cut anywhere in its last 8 bytes (the EOI marker among them), a
    file is truncated for the port exactly where PIL refuses it (and
    where the host's libjpeg warns of a premature end:
    scripts/check_jpeg_tail.py)."""
    data = _jpeg(layout)
    for cut in range(len(data) - 8, len(data) + 1):
        try:
            Image.open(io.BytesIO(data[:cut])).load()
            refused = False
        except OSError:
            refused = True
        got = imageio.decode_jpeg(data[:cut], truncated_ok=True)
        assert got.truncated == refused, (cut, len(data))


def test_cmyk_jpeg_takes_pils_path_in_load_image(tmp_path):
    """The JAX native path cannot decode CMYK: the JAX reader's
    `load_image` converts it with PIL and resizes with BILINEAR."""
    path = str(tmp_path / "cmyk.jpg")
    with open(path, "wb") as f:
        f.write(_jpeg("cmyk"))
    tr = BaseTransforms((32, 48))
    ref = np.asarray(Image.open(path).convert("RGB").resize(
        (48, 32), Image.BILINEAR), np.float32) / 255.0
    np.testing.assert_array_equal(tr.load_image(path), (ref - 0.5) / 0.5)


# ---- PNG -----------------------------------------------------------------

def _png_images():
    r = np.random.RandomState(3)
    p = Image.fromarray(r.randint(0, 21, (37, 29)).astype(np.uint8), "P")
    p.putpalette(list(r.randint(0, 256, 21 * 3)))
    return {
        "L": Image.fromarray((r.rand(37, 29) * 255).astype(np.uint8)),
        "RGB": Image.fromarray((r.rand(37, 29, 3) * 255).astype(np.uint8)),
        "RGBA": Image.fromarray((r.rand(37, 29, 4) * 255).astype(np.uint8)),
        "LA": Image.fromarray((r.rand(37, 29, 2) * 255).astype(np.uint8),
                              "LA"),
        "1": Image.fromarray(r.rand(37, 29) > 0.5),
        "I;16": Image.fromarray((r.rand(37, 29) * 65535).astype(np.uint16)),
        "P": p,
    }


@pytest.mark.parametrize("opts", [{}, dict(optimize=True),
                                  dict(compress_level=0)],
                         ids=["default", "optimize", "stored"])
@pytest.mark.parametrize("mode", sorted(_png_images()))
def test_png_decodes_as_pil(mode, opts):
    data = _save(_png_images()[mode], "PNG", **opts)
    ref = Image.open(io.BytesIO(data))
    got = imageio.decode_png(data)
    assert got.mode == ref.mode
    np.testing.assert_array_equal(got.array, np.asarray(ref))
    assert got.array.dtype == np.asarray(ref).dtype


@pytest.mark.parametrize("bits", [1, 2, 4])
def test_low_bit_depth_png_decodes_as_pil(bits):
    r = np.random.RandomState(bits)
    pal = Image.fromarray(r.randint(0, 2 ** bits, (20, 23)).astype(np.uint8),
                          "P")
    pal.putpalette(list(range(48)))
    data = _save(pal, "PNG", bits=bits)
    ref = Image.open(io.BytesIO(data))
    np.testing.assert_array_equal(imageio.decode_png(data).array,
                                  np.asarray(ref))
    np.testing.assert_array_equal(imageio.decode_png(data).convert(
        "RGB").array, np.asarray(ref.convert("RGB")))


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_png_written_by_the_port_decodes_as_pil(channels):
    r = np.random.RandomState(channels)
    img = (r.rand(19, 31, channels) * 255).astype(np.uint8)
    data = encode_png(img[..., 0] if channels == 1 else img)
    np.testing.assert_array_equal(imageio.decode_png(data).array,
                                  np.asarray(Image.open(io.BytesIO(data))))


@pytest.mark.parametrize("keep", [0.3, 0.5, 0.66, 0.9])
@pytest.mark.parametrize("mode", ["L", "RGB", "P", "RGBA"])
def test_truncated_png_keeps_pils_rows(mode, keep, monkeypatch):
    """Cut short and accepted (PIL's LOAD_TRUNCATED_IMAGES): the whole rows
    that decode, zeros after them, a part-row included; refused without
    the flag, as PIL refuses it."""
    data = _save(_png_images()[mode], "PNG")
    cut = data[:int(len(data) * keep)]
    monkeypatch.setattr(ImageFile, "LOAD_TRUNCATED_IMAGES", True)
    ref = np.asarray(Image.open(io.BytesIO(cut)))
    got = imageio.decode_png(cut, truncated_ok=True)
    assert got.truncated
    np.testing.assert_array_equal(got.array, ref)
    monkeypatch.setattr(ImageFile, "LOAD_TRUNCATED_IMAGES", False)
    with pytest.raises(OSError):
        Image.open(io.BytesIO(cut)).load()
    with pytest.raises(OSError, match="truncated"):
        imageio.decode_png(cut)


@pytest.mark.parametrize("cut", [1, 12, 16, 20])
def test_png_that_lost_only_its_tail_is_whole(cut, strict_pil):
    """All rows decode: PIL (without the flag) and the port take it."""
    data = _save(_png_images()["RGB"], "PNG")[:-cut]
    np.testing.assert_array_equal(imageio.decode_png(data).array,
                                  np.asarray(Image.open(io.BytesIO(data))))


ADAM7_CASES = [(0, 1), (0, 2), (0, 4), (0, 8), (0, 16), (2, 8), (2, 16),
               (3, 1), (3, 2), (3, 4), (3, 8), (4, 8), (4, 16), (6, 8),
               (6, 16)]  # (PNG colour type, bit depth)


def _adam7(ctype, depth, h, w, seed):
    r = np.random.RandomState(seed)
    ch = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    px = r.randint(0, 2 ** depth, (h, w, ch))
    pal = r.randint(0, 256, (2 ** depth, 3)) if ctype == 3 else None
    return encode_png_adam7(px, depth, ctype, pal)


@pytest.mark.parametrize("ctype,depth", ADAM7_CASES)
def test_interlaced_png_decodes_as_pil(ctype, depth):
    """Adam7, every colour type and bit depth `decode_png` takes, images
    smaller than a pass's step included."""
    for h, w in [(1, 1), (3, 5), (9, 13), (37, 29)]:
        data = _adam7(ctype, depth, h, w, seed=h * 7 + depth)
        ref = Image.open(io.BytesIO(data))
        got = imageio.decode_png(data)
        assert got.mode == ref.mode
        np.testing.assert_array_equal(got.array, np.asarray(ref))
        np.testing.assert_array_equal(got.convert("RGB").array,
                                      np.asarray(ref.convert("RGB")))


@pytest.mark.parametrize("keep", [0.3, 0.5, 0.66, 0.9])
@pytest.mark.parametrize("ctype,depth", [(0, 8), (2, 8), (0, 16), (0, 1)])
def test_truncated_interlaced_png_keeps_pils_rows(ctype, depth, keep,
                                                  monkeypatch):
    """Cut short and accepted: the passes' whole rows that decode, zeros
    elsewhere, as PIL gives them; refused without PIL's flag."""
    data = _adam7(ctype, depth, 37, 29, seed=5)
    cut = data[:int(len(data) * keep)]
    monkeypatch.setattr(ImageFile, "LOAD_TRUNCATED_IMAGES", True)
    got = imageio.decode_png(cut, truncated_ok=True)
    assert got.truncated
    np.testing.assert_array_equal(got.array,
                                  np.asarray(Image.open(io.BytesIO(cut))))
    with pytest.raises(OSError, match="truncated"):
        imageio.decode_png(cut)


def test_png_mask_takes_the_jax_native_path(tmp_path):
    """A grayscale mask resizes with the JAX native path's float nearest
    (not always PIL's); an RGB or cut-short mask is not that path's."""
    if not jax_fastio.fastio_available():
        pytest.skip("the JAX package's native decode does not build here")
    r = np.random.RandomState(4)
    ids = r.randint(0, 11, (128, 96)).astype(np.uint8)
    path = str(tmp_path / "m.png")
    Image.fromarray(ids).save(path)
    for size in [(64, 48), (96, 72), (100, 70), (128, 96), (160, 130)]:
        np.testing.assert_array_equal(fastio.decode_png_mask(path, size),
                                      jax_fastio.decode_png_mask(path, size))
    rgb = str(tmp_path / "rgb.png")
    Image.fromarray(np.stack([ids, ids * 3, ids * 7], -1)).save(rgb)
    assert fastio.decode_png_mask(rgb, (64, 48)) is None
    data = open(path, "rb").read()
    with open(path, "wb") as f:
        f.write(data[:len(data) // 2])
    assert fastio.decode_png_mask(path, (64, 48)) is None
    # 16-bit (libpng's 16-to-8 gamma table; with sBIT, fewer bits of it),
    # tRNS at 8, 4 and 16 bits (the transparent id composited to 0), and
    # an interlaced 8-bit mask with tRNS
    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body +
                struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    def gray_png(px, depth, extra=b""):
        rows = b"".join(b"\x00" + (r.astype(">u2").tobytes() if depth == 16
                                   else np.packbits(((r[:, None].astype(
                                       np.uint8) >> np.arange(
                                       depth - 1, -1, -1, dtype=np.uint8))
                                       & 1).ravel()).tobytes())
                        for r in px)
        return (imageio.PNG_SIGNATURE + chunk(b"IHDR", struct.pack(
            ">IIBBBBB", px.shape[1], px.shape[0], depth, 0, 0, 0, 0)) +
            extra + chunk(b"IDAT", zlib.compress(rows)) +
            chunk(b"IEND", b""))

    wide = r.randint(0, 65536, (128, 96))
    masks = {
        "16bit": gray_png(wide, 16),
        "16bit_ids": gray_png(ids.astype(np.int64) * 4099, 16),
        "16bit_sbit": gray_png(wide, 16, chunk(b"sBIT", b"\x0a")),
        "16bit_trns": gray_png(wide, 16, chunk(b"tRNS", struct.pack(
            ">H", int(wide[3, 4])))),
        "8bit_trns": gray_png(ids, 8, chunk(b"tRNS", b"\x00\x03")),
        "4bit_trns": gray_png(ids, 4, chunk(b"tRNS", b"\x00\x07")),
        "8bit_trns_adam7": encode_png_adam7(ids, 8, 0, trns=b"\x00\x05"),
    }
    for name, data in masks.items():
        with open(path, "wb") as f:
            f.write(data)
        for size in [(64, 48), (128, 96), (160, 130)]:
            ref = jax_fastio.decode_png_mask(path, size)
            assert ref is not None, name
            np.testing.assert_array_equal(fastio.decode_png_mask(path, size),
                                          ref, err_msg=name)



def _png_chunk(kind, body):
    return (struct.pack(">I", len(body)) + kind + body +
            struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


@pytest.mark.parametrize("variant", ["plain", "sbit", "trns", "sbit_trns"])
@pytest.mark.parametrize("shape", [(1, 1), (1, 7), (7, 1), (2, 2), (2, 5),
                                   (3, 3), (5, 3), (6, 9), (9, 11), (7, 8),
                                   (16, 16), (32, 7), (33, 64)])
def test_interlaced_16bit_mask_reads_as_libpng(tmp_path, shape, variant):
    """An Adam7 16-bit gray mask through the JAX native path (libpng
    1.6's simplified API) and the port's `decode_png_mask`, bit for bit:
    without tRNS libpng does not return the file's rows (every even row
    is the row above it, row 0 the last rows of passes 1-6), with tRNS it
    does; sBIT changes the gamma table. At native size and two resizes."""
    if not jax_fastio.fastio_available():
        pytest.skip("the JAX package's native decode does not build here")
    H, W = shape
    r = np.random.RandomState(H * 100 + W)
    key = 30000
    if "trns" in variant:  # few values, the transparent one among them
        px = r.choice([0, 257, 4000, key, 65535], (H, W))
    else:
        px = r.randint(0, 65536, (H, W))
    data = encode_png_adam7(px, depth=16, trns=struct.pack(">H", key)
                            if "trns" in variant else None)
    if "sbit" in variant:  # after IHDR: 8 bytes of signature, 25 of IHDR
        data = data[:33] + _png_chunk(b"sBIT", b"\x09") + data[33:]
    path = str(tmp_path / "m.png")
    with open(path, "wb") as f:
        f.write(data)
    for size in [(H, W), (max(1, H // 2), max(1, W // 3)),
                 (2 * H + 3, 2 * W + 1)]:
        ref = jax_fastio.decode_png_mask(path, size)
        assert ref is not None
        np.testing.assert_array_equal(fastio.decode_png_mask(path, size),
                                      ref, err_msg=str(size))


# ---- conversions and resizes ---------------------------------------------

CONVERSIONS = [(src, dst) for src in ("P", "RGBA", "LA", "L", "1", "RGB")
               for dst in ("RGB", "L")] + [("CMYK", "RGB")]


@pytest.mark.parametrize("src,dst", CONVERSIONS)
def test_convert_is_pils(src, dst):
    if src == "CMYK":
        data = _jpeg("cmyk")
        img, got = Image.open(io.BytesIO(data)), imageio.decode_jpeg(data)
    else:
        data = _save(_png_images()[src], "PNG")
        img, got = Image.open(io.BytesIO(data)), imageio.decode_png(data)
    np.testing.assert_array_equal(got.convert(dst).array,
                                  np.asarray(img.convert(dst)))


RESIZES = [((37, 29), (128, 128)), ((128, 128), (64, 64)),
           ((240, 320), (128, 128)), ((192, 192), (128, 128)),
           ((218, 178), (128, 128)), ((5, 3), (97, 131)), ((1, 7), (4, 4)),
           ((96, 96), (64, 80)), ((128, 128), (96, 96)), ((64, 64), (300, 13))]
# COCO's _resize_min_shape: (H, W) -> the size that covers the resolution
COCO = [((480, 640), (224, 224)), ((427, 640), (224, 224)),
        ((640, 480), (128, 128)), ((333, 500), (320, 320)),
        ((500, 375), (224, 224))]


def _cover(shape, res):
    H, W = shape
    scale = max(res[0] / H, res[1] / W)
    return (int(round(H * scale)), int(round(W * scale)))


@pytest.mark.parametrize("shape,size", RESIZES + [
    (s, _cover(s, res)) for s, res in COCO])
def test_resizes_are_pils(shape, size):
    r = np.random.RandomState(shape[0] * 7 + size[1])
    rgb = (r.rand(*shape, 3) * 255).astype(np.uint8)
    gray = rgb[..., 0].copy()
    ids = r.randint(-5, 1000, shape).astype(np.int32)
    wh = size[::-1]
    np.testing.assert_array_equal(
        imageio.resize_bilinear(rgb, size),
        np.asarray(Image.fromarray(rgb).resize(wh, Image.BILINEAR)))
    np.testing.assert_array_equal(
        imageio.resize_bilinear(gray, size),
        np.asarray(Image.fromarray(gray).resize(wh, Image.BILINEAR)))
    np.testing.assert_array_equal(
        imageio.resize_nearest(gray, size),
        np.asarray(Image.fromarray(gray).resize(wh, Image.NEAREST)))
    np.testing.assert_array_equal(
        imageio.resize_nearest(rgb, size),
        np.asarray(Image.fromarray(rgb).resize(wh, Image.NEAREST)))
    np.testing.assert_array_equal(
        imageio.resize_nearest(ids, size),
        np.asarray(Image.fromarray(ids, mode="I").resize(wh, Image.NEAREST),
                   np.int32))


def test_crop_and_flip_are_pils():
    r = np.random.RandomState(5)
    img = (r.rand(20, 30, 3) * 255).astype(np.uint8)
    for box in [(3, 4, 13, 19), (-5, -2, 10, 10), (25, 15, 40, 31)]:
        np.testing.assert_array_equal(imageio.crop(img, box), np.asarray(
            Image.fromarray(img).crop(box)))
    np.testing.assert_array_equal(
        imageio.flip_left_right(img),
        np.asarray(Image.fromarray(img).transpose(Image.FLIP_LEFT_RIGHT)))


# ---- polygons ------------------------------------------------------------

def _pil_polygons(polys, size):
    h, w = size
    img = Image.new("1", (w, h), 0)
    draw = ImageDraw.Draw(img)
    for poly in polys:
        xy = [(poly[i], poly[i + 1]) for i in range(0, len(poly) - 1, 2)]
        if len(xy) >= 3:
            draw.polygon(xy, outline=1, fill=1)
    return np.asarray(img, np.uint8)


def _convex(r, h, w, jitter):
    k = r.randint(3, 12)
    ang = np.sort(r.rand(k) * 2 * np.pi)
    rad = 2 + r.rand(k if jitter else 1) * min(h, w) / 2
    cx, cy = r.rand() * w, r.rand() * h
    return list(np.stack([cx + rad * np.cos(ang), cy + rad * np.sin(ang)],
                         1).ravel())


def _contour(r, h, w):
    """An annotator's outline: many float vertices around a wobbly blob
    (neighbours often land on one pixel)."""
    k = r.randint(8, 80)
    ang = np.linspace(0, 2 * np.pi, k, endpoint=False) + r.rand() * 0.1
    rad = (3 + r.rand() * min(h, w) / 3) * (
        1 + 0.3 * np.sin(3 * ang + r.rand() * 6) + 0.15 * r.randn(k))
    cx, cy = r.rand() * w, r.rand() * h
    return list(np.stack([cx + rad * np.cos(ang), cy + rad * np.sin(ang)],
                         1).ravel())


def _random(r, h, w, kind):
    k = r.randint(3, 10)
    if kind == 0:  # anywhere in the image, crossing itself
        return list(r.rand(2 * k) * np.tile([w, h], k))
    if kind == 1:  # integer vertices, some off the image
        return list(r.randint(-5, max(h, w) + 5, 2 * k).astype(float))
    if kind == 2:  # half-pixel vertices
        return list(np.round(r.rand(2 * k) * np.tile([w, h], k) * 2) / 2)
    xs, ys = r.randint(0, w, k), r.randint(0, h, k)  # horizontal runs
    ys[::2] = ys[0]
    return list(np.stack([xs, ys], 1).ravel().astype(float))


@pytest.mark.parametrize("shape", ["convex", "star", "coco_generator",
                                   "contour"])
def test_polygons_are_pils(shape):
    r = np.random.RandomState(6)
    for _ in range(300):
        h, w = r.randint(8, 80), r.randint(8, 80)
        if shape == "coco_generator":
            polys = [[float(v) for p in _shape_polygon(r, h, w, r.randint(3))
                      for v in p] for _ in range(r.randint(1, 4))]
        elif shape == "contour":
            polys = [_contour(r, h, w) for _ in range(r.randint(1, 4))]
        else:
            polys = [_convex(r, h, w, shape == "star")
                     for _ in range(r.randint(1, 4))]
        np.testing.assert_array_equal(imageio.polygon_mask(polys, (h, w)),
                                      _pil_polygons(polys, (h, w)))


def test_random_polygons_agree_with_pil():
    """Crossing, touching, off-image and degenerate polygons, vertices
    revisited and left of the image among them: every set bit for
    bit."""
    r = np.random.RandomState(3)
    sets = differ = pixels = total = 0
    for t in range(2000):
        h, w = r.randint(4, 40), r.randint(4, 40)
        polys = [_random(r, h, w, t % 4) for _ in range(r.randint(1, 3))]
        a = imageio.polygon_mask(polys, (h, w))
        b = _pil_polygons(polys, (h, w))
        sets += 1
        differ += not np.array_equal(a, b)
        pixels += int((a != b).sum())
        total += a.size
    assert differ == 0, (differ, sets)
    assert pixels == 0, (pixels, total)


REVISITS = [  # vertices revisited (corners of four edges), left of the image
    (20, 5, [2, 7, 0, 14, 2, 7, 4, 8]), (17, 14, [6, 9, 7, 10, 6, 9, 4, 10]),
    (8, 37, [19, 2, 24, 4, 19, 2, 12, 3]),
    (14, 21, [0, 4, 6, 1, 8, 4, 15, 0, 8, 4]),
    (4, 10, [8, 0, 7, 1, 5, 3, 0, 2, 5, 3]),
    (7, 4, [3, 5, 3, 4, 0, 5, 3, 4, 3, 5]),
    (31, 31, [-2, 28, 28, 35, 8, -2, 18, 27, 8, 32]),
    (11, 17, [-3, -1, 18, 17, -2, 9, 6, 12, 11, 18, 7, 19]),
    (6, 5, [3, 3, 0, 4, 0, 3, 2, 4, 0, 3, 0, 4, 0, 3, 2, 5])]


@pytest.mark.parametrize("h,w,xy", REVISITS)
def test_polygons_that_revisit_a_vertex_or_leave_the_image_are_pils(h, w,
                                                                    xy):
    """Pillow's corner rule: the first earlier sloped edge meeting this
    one at its end row makes the corner, and the widened span's end is
    rounded half up."""
    poly = [float(v) for v in xy]
    np.testing.assert_array_equal(imageio.polygon_mask([poly], (h, w)),
                                  _pil_polygons([poly], (h, w)))


def test_degenerate_polygons_draw_what_pil_draws():
    """A point, a line, a repeated vertex, fewer than three vertices."""
    cases = [[5, 5, 5, 5, 5, 5], [2, 3, 9, 3, 4, 3], [1, 1, 8, 8, 1, 1],
             [2, 2, 7, 2], [3, 1, 3, 9, 3, 4, 3, 1], [0, 0, 19, 0, 19, 0]]
    for poly in cases:
        np.testing.assert_array_equal(
            imageio.polygon_mask([[float(v) for v in poly]], (12, 20)),
            _pil_polygons([poly], (12, 20)))


# ---- the native build ----------------------------------------------------

def test_a_failed_build_names_the_compiler(monkeypatch, tmp_path):
    """No silent fallback: a build that cannot run says why."""
    monkeypatch.setattr(fastio, "_lib", None)
    monkeypatch.setattr(fastio, "BUILD_ROOT", str(tmp_path))
    monkeypatch.setattr(fastio, "CXX", "no-such-compiler-x")
    with pytest.raises(fastio.NativeLibraryError, match="no-such-compiler-x"):
        fastio.lib()


def test_png_chunk_stream_is_read_as_written():
    """A PNG split over several IDAT chunks, with ancillary chunks."""
    img = (np.random.RandomState(7).rand(30, 40, 3) * 255).astype(np.uint8)
    z = zlib.compress(np.concatenate([np.zeros((30, 1), np.uint8),
                                      img.reshape(30, -1)], 1).tobytes())

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body +
                struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))
    data = (imageio.PNG_SIGNATURE +
            chunk(b"IHDR", struct.pack(">IIBBBBB", 40, 30, 8, 2, 0, 0, 0)) +
            chunk(b"tEXt", b"k\x00v") +
            b"".join(chunk(b"IDAT", z[i:i + 100])
                     for i in range(0, len(z), 100)) + chunk(b"IEND", b""))
    np.testing.assert_array_equal(imageio.decode_png(data).array, img)
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(data))),
                                  img)
