"""The port's image files without PIL (`slotdiffusion_tpu_torch/data/
imageio.py` and `csrc/imageio.cpp`) against PIL 12 on this host, the
yardstick, and against the JAX package's native decode (libjpeg) for what
PIL does not do the way the JAX readers do.

Bit for bit: PNG of every colour type (written by PIL and by the port's
own `utils/png.py`), cut short or whole; `convert("RGB")` and
`convert("L")`; BILINEAR and NEAREST resizes up and down (COCO's
`_resize_min_shape` sizes, int32 "I" masks); baseline JPEG in 4:4:4,
4:2:2, 4:2:0, grayscale, CMYK and with restart intervals; a JPEG cut short
against libjpeg through the JAX native path (PIL decodes one it is told to
accept otherwise: it stops where its data stops); the fused decode and
resize of the JAX native path. Polygons: bit for bit on convex and star
shapes, annotators' outlines and the shapes of the COCO generator; on
random polygons that
may cross and touch themselves and leave the image, at least 99.5% of the
polygon sets are bit for bit and at most 1e-5 of the pixels differ (a
polygon that revisits a vertex can differ at a few pixels, see
ROADMAP.md).
"""

import io
import os
import struct
import sys
import zlib

import numpy as np
import pytest
from PIL import Image, ImageDraw, ImageFile

from slotdiffusion_tpu.data import fastio as jax_fastio
from slotdiffusion_tpu_torch.data import fastio, imageio
from slotdiffusion_tpu_torch.data.transforms import BaseTransforms
from slotdiffusion_tpu_torch.utils.png import encode_png

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scripts", "data_utils"))
from gen_mini_seg_data import _shape_polygon  # noqa: E402


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


def _jpeg(name, seed=0):
    kw = dict(JPEG_LAYOUTS[name])
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


def test_progressive_jpeg_is_refused_with_its_name(tmp_path):
    path = str(tmp_path / "progressive.jpg")
    Image.fromarray(_textured(np.random.RandomState(2), 32, 32)).save(
        path, progressive=True)
    with pytest.raises(OSError, match="progressive.jpg.*progressive"):
        imageio.read_image(path)


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


def test_interlaced_png_is_refused():
    data = bytearray(encode_png(np.zeros((4, 4), np.uint8)))
    data[8 + 8 + 12] = 1  # IHDR's interlace byte
    with pytest.raises(OSError, match="interlaced"):
        imageio.decode_png(bytes(data))


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
    """Crossing, touching, off-image and degenerate polygons: at least
    99.5% of the sets bit for bit, at most 1e-5 of the pixels apart
    (measured on this draw: 22 sets of 20000 differ in this mix, each
    revisiting a vertex or with one left of the image)."""
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
    assert differ <= 0.005 * sets, (differ, sets)
    assert pixels <= 1e-5 * total, (pixels, total)


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
