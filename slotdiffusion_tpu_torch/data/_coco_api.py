"""A minimal pure-Python/numpy COCO annotation reader (an own copy of the
JAX package's data/_coco_api.py:27-157): the subset of
`pycocotools.coco.COCO` that `data/coco.py` reads (`getImgIds`,
`getCatIds`, `getAnnIds`, `loadImgs`, `loadAnns`, `annToMask`) over the
`instances_*.json` format, with every on-disk segmentation encoding:

- polygon lists `[[x1, y1, x2, y2, ...], ...]`, filled as the JAX
  reader's PIL `ImageDraw.polygon` fills them (`imageio.polygon_mask`; a
  border pixel may differ from pycocotools' own rasterizer);
- uncompressed RLE `{"counts": [int, ...], "size": [h, w]}`;
- compressed RLE strings (pycocotools mask.c's 5-bit varint with the
  counts from the third on delta-coded), as crowd annotations carry.

`data/coco.py` takes pycocotools where it is installed and this reader
otherwise.
"""

import json

import numpy as np


def decode_rle_string(s):
    """COCO compressed RLE string -> list of run counts (mask.c
    rleFrString: 5 data bits per char offset by 48, bit 0x20 =
    continuation, sign-extended, counts[i>=2] delta-coded vs
    counts[i-2])."""
    counts = []
    p = 0
    while p < len(s):
        x, k, more = 0, 0, True
        while more:
            c = ord(s[p]) - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            p += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return counts


def encode_rle_string(counts):
    """Run counts -> COCO compressed string (mask.c rleToString inverse
    of decode_rle_string: 5-bit varint, counts[i>=2] delta-coded)."""
    s = []
    for i, x in enumerate(counts):
        if i > 2:
            x -= counts[i - 2]
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            more = (x != -1 if c & 0x10 else x != 0)
            if more:
                c |= 0x20
            s.append(chr(c + 48))
    return "".join(s)


def mask_to_rle(mask):
    """bool [H, W] -> column-major run counts (first run = zeros)."""
    flat = np.asarray(mask, bool).T.flatten()
    counts, prev = [], 0
    for c in np.flatnonzero(np.diff(flat.astype(np.int8))):
        counts.append(int(c + 1 - prev))
        prev = int(c + 1)
    counts.append(int(flat.size - prev))
    if flat[0]:  # counts must start with a zero-run
        counts.insert(0, 0)
    return counts


def rle_to_mask(counts, size):
    """Run counts (column-major, first run is zeros) -> [H, W] uint8."""
    h, w = size
    flat = np.zeros(h * w, np.uint8)
    pos, val = 0, 0
    for c in counts:
        if val:
            flat[pos:pos + c] = 1
        pos += c
        val ^= 1
    return flat.reshape((w, h)).T  # column-major storage


def polygons_to_mask(polys, size):
    """Polygon list -> [H, W] uint8 of their union, rasterised as PIL's
    `ImageDraw.polygon(xy, fill=1, outline=1)` does it."""
    from .imageio import polygon_mask
    return polygon_mask(polys, size)


class MiniCOCO:
    """Drop-in for the `pycocotools.coco.COCO` subset used here."""

    def __init__(self, annotation_file):
        with open(annotation_file) as f:
            d = json.load(f)
        self.imgs = {img["id"]: img for img in d.get("images", [])}
        self.cats = {c["id"]: c for c in d.get("categories", [])}
        self.anns = {a["id"]: a for a in d.get("annotations", [])}
        self.img_to_anns = {}
        for a in d.get("annotations", []):
            self.img_to_anns.setdefault(a["image_id"], []).append(a["id"])

    def getImgIds(self):
        return list(self.imgs.keys())

    def getCatIds(self):
        return list(self.cats.keys())

    def getAnnIds(self, imgIds=None):
        if imgIds is None:
            return list(self.anns.keys())
        if not isinstance(imgIds, (list, tuple)):
            imgIds = [imgIds]
        out = []
        for i in imgIds:
            out.extend(self.img_to_anns.get(i, []))
        return out

    def loadImgs(self, ids):
        if not isinstance(ids, (list, tuple)):
            ids = [ids]
        return [self.imgs[i] for i in ids]

    def loadAnns(self, ids):
        if not isinstance(ids, (list, tuple)):
            ids = [ids]
        return [self.anns[i] for i in ids]

    def annToMask(self, ann):
        seg = ann["segmentation"]
        info = self.imgs[ann["image_id"]]
        size = (info["height"], info["width"])
        if isinstance(seg, list):
            return polygons_to_mask(seg, size)
        counts = seg["counts"]
        size = tuple(seg.get("size", size))
        if isinstance(counts, str):
            counts = decode_rle_string(counts)
        return rle_to_mask(counts, size)
