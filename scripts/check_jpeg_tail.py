"""Where a JPEG cut short is taken as whole or as truncated, by each of
the JAX readers' two decoders on this host and by the port.

    python scripts/check_jpeg_tail.py [--layouts 10]

For JPEGs of the layouts `tests/test_torch_imageio.py` writes (4:4:4,
4:2:2, 4:2:0, gray, CMYK, restart intervals, odd and CelebA sizes), every
cut point from the first scan's data to one byte short of the file is
read three ways:
- PIL with its truncation flag off (CelebA, COCO, VOC and ClevrTex go
  through it): refused ("image file is truncated") or taken;
- the host's libjpeg from memory, as the JAX package's native path
  (MOVi and Physion frames) reads it: whether it warns of a premature
  end (`jpeg_eof_probe.c`, built here with gcc against the host's
  libjpeg);
- the port's decoder (`slotdiffusion_tpu_torch.data.imageio`): whether
  it reports the data to end early.
It prints the count of cut points, each pair's disagreements and how far
from the end of the file each lies. Needs PIL, gcc and libjpeg's headers.
"""

import argparse
import io
import os
import struct
import subprocess
import sys
import tempfile

import numpy as np
from PIL import Image, ImageFile

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(_HERE))

from slotdiffusion_tpu_torch.data import imageio  # noqa: E402

LAYOUTS = [  # (PIL mode, size, save keywords)
    ("RGB", (64, 96), dict(subsampling=0)),
    ("RGB", (64, 96), dict(subsampling=1)),
    ("RGB", (64, 96), dict(subsampling=2)),
    ("L", (64, 96), {}),
    ("RGB", (37, 53), dict(subsampling=2, quality=50)),
    ("RGB", (3, 5), dict(subsampling=0)),
    ("RGB", (64, 96), dict(subsampling=2, restart_marker_blocks=3)),
    ("RGB", (64, 96), dict(subsampling=0, restart_marker_rows=1)),
    ("CMYK", (64, 96), {}),
    ("RGB", (218, 178), dict(subsampling=2)),
]


def _file(mode, size, kw, seed):
    r = np.random.RandomState(seed)
    h, w = size
    c = 4 if mode == "CMYK" else 3
    base = np.kron(r.rand(h // 8 + 2, w // 8 + 2, c), np.ones((8, 8, 1)))
    img = (base[:h, :w] * 200 + r.rand(h, w, c) * 55).clip(0, 255).astype(
        np.uint8)
    pil = Image.fromarray(img, "CMYK") if mode == "CMYK" else \
        Image.fromarray(img).convert(mode)
    b = io.BytesIO()
    pil.save(b, "JPEG", **dict(dict(quality=90), **kw))
    return b.getvalue()


def _scan_start(data):
    """Offset of the first scan's entropy-coded data."""
    pos = 2
    while True:
        while data[pos] != 0xFF:
            pos += 1
        while data[pos] == 0xFF:
            pos += 1
        m, n = data[pos], struct.unpack(">H", data[pos + 1:pos + 3])[0]
        if m == 0xDA:
            return pos + 1 + n
        pos += 1 + n


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--layouts", type=int, default=len(LAYOUTS))
    args = ap.parse_args()
    ImageFile.LOAD_TRUNCATED_IMAGES = False
    tmp = tempfile.mkdtemp()
    probe = os.path.join(tmp, "jpeg_eof_probe")
    subprocess.run(["gcc", "-O2", "-o", probe,
                    os.path.join(_HERE, "jpeg_eof_probe.c"), "-ljpeg"],
                   check=True)
    cuts, verdicts = [], []
    for i, (mode, size, kw) in enumerate(LAYOUTS[:args.layouts]):
        data = _file(mode, size, kw, seed=i)
        for cut in range(_scan_start(data), len(data)):
            cuts.append((i, cut, len(data) - cut, data[:cut]))
    feed = b"".join(struct.pack("<I", len(d)) + d for *_, d in cuts)
    native = subprocess.run([probe], input=feed, capture_output=True,
                            check=True).stdout.decode().split("\n")
    for (i, cut, short, d), line in zip(cuts, native):
        try:
            Image.open(io.BytesIO(d)).load()
            pil = False
        except OSError:
            pil = True
        lib = line.startswith("eof 1")
        try:
            port = imageio.decode_jpeg(d, truncated_ok=True).truncated
        except OSError:
            port = True
        verdicts.append((i, cut, short, pil, lib, port))
    print(f"{len(verdicts)} cut points over {args.layouts} layouts "
          f"(each a file cut from its first scan's data to its last byte)")
    names = {3: "PIL refuses", 4: "libjpeg warns", 5: "port truncated"}
    for a, b in [(3, 4), (5, 3), (5, 4)]:
        off = [v for v in verdicts if v[a] != v[b]]
        short = sorted({v[2] for v in off})
        print(f"{names[a]} / {names[b]}: {len(off)} disagree "
              f"({sum(v[a] for v in off)} where only the first says so); "
              f"bytes short of the whole file: "
              f"{short if len(short) <= 20 else f'{short[0]}..{short[-1]}'}"
              + "".join(f"; layout {v[0]} cut {v[1]}" for v in off[:6]))


if __name__ == "__main__":
    main()
