"""Write the small file tree the port's readers are checked against, and
what the JAX package's readers return for every item of it.

The tree (default `tests/data/torch_files/`) holds one small dataset of
each layout the readers take, made with the JAX package's own generators
(`scripts/gen_movi_tree.py`, `scripts/data_utils/gen_mini_seg_data.py`)
and its synthetic scenes:
- `movi/MOVi-E`: MOVi-E at 128x128 (the `download_movi.py` default), 2
  train and 2 validation videos of 24 JPEG frames with grayscale id
  masks; one mask PNG cut to two thirds of its bytes and one frame JPEG
  cut to half;
- `movi/MOVi-C`: one validation video of RGB-coded id masks;
- `movi/MOVi-Solid`: one STEVE-MOVi video (PNG frames, 10 binary masks a
  frame);
- `clevrtex/clevrtex_full`: 10 CLEVRTex scenes at their 320x240 with
  `_flat.png` id masks (one image RGBA, one mask a palette PNG);
- `celeba`: 3 CelebA images at their 178x218, the test one cut short;
- `coco`: COCO val/train with polygons and a compressed-RLE crowd
  annotation, one grayscale and one CMYK JPEG;
- `voc`: VOC with palette masks and the 255 void ring;
- `physion`: one short Physion clip;
and, recoded in place (`RECODED`), the formats beyond baseline JPEG and
plain PNG that the readers take: a progressive image each for CelebA,
COCO and VOC and progressive, arithmetic-coded and arithmetic
progressive MOVi frames (ITU T.81 SOF2, SOF9, SOF10), an Adam7-interlaced
ClevrTex image and mask, a 16-bit and a tRNS MOVi mask. PIL writes the
strict readers' progressive files; the MOVi frames are transcoded from
their own DCT coefficients (`scripts/arith_jpeg.c transcode`, compiled
here with gcc against this host's libjpeg; the card needs neither), so
they decode to the very pixels they had and the flagship's file-backed
steps and validation on the card (`chip_smoke.py` phase 19) see the same
clips; the interlaced PNGs come from `scripts/png_adam7.py`.

`cases.json` names each reader's arguments (paths relative to the tree),
and `references.npz` holds every item each JAX reader returns, or the
exception it raises. Images whose values are a uint8 code under one of the
two normalisations are stored as the code (checked here to give back the
JAX reader's floats bit for bit); identical arrays are stored once. The
strict readers are read before the MOVi and Physion modules are imported,
since those set PIL's `ImageFile.LOAD_TRUNCATED_IMAGES` for the process.

Imports the JAX package and PIL, and builds the C helper, so it runs on a
host that has them, gcc and libjpeg's headers:

    python scripts/make_torch_data_fixture.py [--out tests/data/torch_files]
"""

import argparse
import hashlib
import json
import os
import os.path as osp
import shutil
import struct
import subprocess
import sys
import tempfile
import zlib

import numpy as np
from PIL import Image, ImageFile

_REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
sys.path.insert(0, _REPO)
sys.path.insert(0, osp.join(_REPO, "scripts"))
sys.path.insert(0, osp.join(_REPO, "scripts", "data_utils"))

from gen_mini_seg_data import gen_coco, gen_voc  # noqa: E402
from gen_movi_tree import write_split  # noqa: E402
from png_adam7 import encode_png_adam7  # noqa: E402
from slotdiffusion_tpu.data.synthetic import (  # noqa: E402
    SyntheticImageDataset, SyntheticVideoDataset)
from slotdiffusion_tpu_torch.data.reference_files import decode  # noqa: E402

MOVI_RES = 128
# each reader case: (name, reader, keyword arguments; `data_root` is
# relative to the tree). Strict readers come first (see the docstring)
CASES = [
    ("celeba_train", "celeba", dict(data_root="celeba", resolution=[128, 128],
                                    split="train")),
    ("celeba_val", "celeba", dict(data_root="celeba", resolution=[128, 128],
                                  split="val")),
    ("celeba_test", "celeba", dict(data_root="celeba", resolution=[128, 128],
                                   split="test")),
    ("clevrtex_train", "clevrtex", dict(data_root="clevrtex",
                                        resolution=[128, 128],
                                        split="train")),
    ("clevrtex_val", "clevrtex", dict(data_root="clevrtex",
                                      resolution=[128, 128], split="val")),
    ("clevrtex_test", "clevrtex", dict(data_root="clevrtex",
                                       resolution=[96, 96], split="test")),
    ("coco_val", "coco", dict(data_root="coco", resolution=[64, 64],
                              split="val")),
    ("coco_train", "coco", dict(data_root="coco", resolution=[80, 64],
                                split="train")),
    ("voc_val", "voc", dict(data_root="voc", resolution=[64, 64],
                            split="val")),
    ("voc_trainaug", "voc", dict(data_root="voc", resolution=[64, 80],
                                 split="trainaug")),
    ("movi_e_train", "movi", dict(level="E", data_root="movi",
                                  resolution=[128, 128], split="train",
                                  n_sample_frames=6, load_mask=True)),
    ("movi_e_val", "movi", dict(level="E", data_root="movi",
                                resolution=[128, 128], split="val",
                                n_sample_frames=6, load_mask=True)),
    ("movi_rgb_ids_res64", "movi", dict(level="C", data_root="movi",
                                        resolution=[64, 64], split="val",
                                        n_sample_frames=6, video_len=6,
                                        load_mask=True)),
    ("steve_movi", "movi", dict(level="Solid", data_root="movi",
                                resolution=[96, 96], split="val",
                                n_sample_frames=3, video_len=3,
                                load_mask=True, layout="steve_movi")),
    ("physion_train", "physion", dict(data_root="physion",
                                      resolution=[64, 64], split="train",
                                      n_sample_frames=6, video_len=12,
                                      subset="training")),
]
RECODED = {  # file -> how it is rewritten (before any cut)
    "celeba/img_align_celeba/000001.jpg": "progressive",
    "coco/val2017/000000100000.jpg": "progressive",
    "voc/JPEGImages/2012_000000.jpg": "progressive",
    "movi/MOVi-E/train/00000/000003.jpg": "progressive_transcoded",
    "movi/MOVi-E/train/00000/000004.jpg": "arithmetic",
    "movi/MOVi-E/validation/00001/000002.jpg": "arithmetic_progressive",
    "clevrtex/clevrtex_full/0/CLEVRTEX_full_000007.png": "adam7",
    "clevrtex/clevrtex_full/0/CLEVRTEX_full_000007_flat.png": "adam7",
    "movi/MOVi-E/train/00001/000001_mask.png": "16bit",
    "movi/MOVi-E/train/00001/000003_mask.png": "trns",
}
TRUNCATED = {  # file -> fraction of its bytes kept
    "movi/MOVi-E/train/00000/000002_mask.png": 2 / 3,
    "movi/MOVi-E/train/00001/000005.jpg": 1 / 2,
    "celeba/img_align_celeba/000002.jpg": 1 / 2,
}


def _u8(img):
    return (np.clip(img, 0.0, 1.0) * 255).astype(np.uint8)


def write_tree(root):
    rng = np.random.RandomState(0)
    # MOVi-E: the JAX generator's layout and content
    movi = osp.join(root, "movi")
    write_split(movi, "E", "train", 2, 24, MOVI_RES, seed=0)
    write_split(movi, "E", "validation", 2, 24, MOVI_RES, seed=1)
    # one video of RGB-coded id masks
    video = SyntheticVideoDataset((MOVI_RES, MOVI_RES), num_samples=1,
                                  n_sample_frames=6, seed=2)[0]
    vdir = osp.join(movi, "MOVi-C", "validation", "00000")
    os.makedirs(vdir)
    codes = rng.randint(0, 256, (16, 3)).astype(np.uint8)
    for t in range(6):
        Image.fromarray(_u8((video["img"][t] + 1) / 2)).save(
            osp.join(vdir, f"{t:06d}.jpg"), quality=95)
        Image.fromarray(codes[video["masks"][t]]).save(
            osp.join(vdir, f"{t:06d}_mask.png"))
    # one STEVE-MOVi video: PNG frames, 10 binary masks a frame
    video = SyntheticVideoDataset((MOVI_RES, MOVI_RES), num_samples=1,
                                  n_sample_frames=3, seed=3)[0]
    vdir = osp.join(movi, "MOVi-Solid", "test", "00000")
    os.makedirs(vdir)
    for t in range(3):
        Image.fromarray(_u8((video["img"][t] + 1) / 2)).save(
            osp.join(vdir, f"{t:08d}_image.png"))
        for k in range(10):
            Image.fromarray(((video["masks"][t] == k + 1) * 255).astype(
                np.uint8)).save(osp.join(vdir, f"{t:08d}_mask_{k:02d}.png"))
    # CLEVRTex at its 320x240
    cdir = osp.join(root, "clevrtex", "clevrtex_full", "0")
    os.makedirs(cdir)
    scenes = SyntheticImageDataset((240, 320), num_samples=10, seed=4)
    for i in range(10):
        s = scenes[i]
        img = _u8((s["img"] + 1) / 2)
        if i == 3:
            img = np.concatenate([img, np.full((240, 320, 1), 200, np.uint8)],
                                 axis=2)
        Image.fromarray(img).save(osp.join(cdir, f"CLEVRTEX_full_{i:06d}.png"))
        msk = Image.fromarray(s["masks"].astype(np.uint8))
        if i == 5:
            msk = msk.convert("P")
        msk.save(osp.join(cdir, f"CLEVRTEX_full_{i:06d}_flat.png"))
    # CelebA at its 178x218
    adir = osp.join(root, "celeba", "img_align_celeba")
    os.makedirs(adir)
    faces = SyntheticImageDataset((218, 178), num_samples=3, seed=5)
    lines = []
    for i in range(3):
        img = (faces[i]["img"] + 1) / 2 + rng.rand(218, 178, 3) * 0.1
        Image.fromarray(_u8(img)).save(osp.join(adir, f"{i:06d}.jpg"),
                                       quality=90)
        lines.append(f"{i:06d}.jpg {i}")
    with open(osp.join(root, "celeba", "list_eval_partition.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    # COCO and VOC: the JAX generator, then a grayscale and a CMYK JPEG
    gen_coco(osp.join(root, "coco"), 2, 3, 96, seed=0)
    vals = sorted(os.listdir(osp.join(root, "coco", "val2017")))
    for name, mode in zip(vals[1:3], ("L", "CMYK")):
        p = osp.join(root, "coco", "val2017", name)
        Image.open(p).convert(mode).save(p, quality=95)
    gen_voc(osp.join(root, "voc"), 4, 96, seed=0)
    # Physion: one short clip of one task
    pdir = osp.join(root, "physion")
    clip = SyntheticVideoDataset((64, 64), num_samples=1, n_sample_frames=12,
                                 seed=6)[0]
    vdir = osp.join(pdir, "collide_vid0_img")
    os.makedirs(vdir)
    for t in range(12):
        Image.fromarray(_u8((clip["img"][t] + 1) / 2)).save(
            osp.join(vdir, f"{t:06d}.jpg"), quality=95)
    os.makedirs(osp.join(pdir, "splits"))
    for split in ("train", "val"):
        with open(osp.join(pdir, "splits", f"training_{split}.json"),
                  "w") as f:
            json.dump({"Collide": ["collide_vid0_img.mp4"]}, f)
    recode(root)
    for rel, keep in TRUNCATED.items():
        p = osp.join(root, rel)
        with open(p, "rb") as f:
            data = f.read()
        with open(p, "wb") as f:
            f.write(data[:int(len(data) * keep)])


def _arith_helper():
    """scripts/arith_jpeg.c built against this host's libjpeg."""
    src = osp.join(_REPO, "scripts", "arith_jpeg.c")
    exe = osp.join(tempfile.mkdtemp(), "arith_jpeg")
    subprocess.run(["gcc", "-O2", "-o", exe, src, "-ljpeg"], check=True)
    return exe


def _png_chunk(kind, body):
    return (struct.pack(">I", len(body)) + kind + body +
            struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def recode(root):
    """Rewrite the files of RECODED in place, in another format: a PNG
    with the same pixels, a MOVi frame with the same DCT coefficients (so
    the same pixels), a strict reader's image re-encoded progressive by
    PIL."""
    helper = None
    for rel, how in RECODED.items():
        p = osp.join(root, rel)
        img = np.asarray(Image.open(p))
        if how == "progressive":
            Image.fromarray(img).save(p, quality=90, progressive=True)
        elif how in ("progressive_transcoded", "arithmetic",
                     "arithmetic_progressive"):
            helper = helper or _arith_helper()
            with open(p, "rb") as f:
                data = f.read()
            out = subprocess.run(
                [helper, "transcode", str(int(how.startswith("arith"))),
                 str(int("progressive" in how))], input=data,
                capture_output=True, check=True).stdout
            with open(p, "wb") as f:
                f.write(out)
        elif how == "adam7":
            if img.ndim == 2:
                data = encode_png_adam7(img, 8, 0)
            else:
                data = encode_png_adam7(img, 8, {3: 2, 4: 6}[img.shape[2]])
            with open(p, "wb") as f:
                f.write(data)
        elif how == "16bit":  # ids spread over the 16 bits
            Image.fromarray(img.astype(np.uint16) * 4099).save(p)
        elif how == "trns":  # id 1 transparent: libpng composites it to 0
            with open(p, "rb") as f:
                data = f.read()
            end = data.index(b"IDAT") - 4
            with open(p, "wb") as f:
                f.write(data[:end] + _png_chunk(b"tRNS", b"\x00\x01") +
                        data[end:])
        else:
            raise ValueError(how)


def jax_reader(kind, kw, root):
    """The JAX package's dataset for one case."""
    kw = dict(kw, data_root=osp.join(root, kw["data_root"]))
    if kind == "celeba":
        from slotdiffusion_tpu.data.celeba import CelebADataset
        return CelebADataset(**kw)
    if kind == "clevrtex":
        from slotdiffusion_tpu.data.clevrtex import CLEVRTexDataset
        return CLEVRTexDataset(**kw)
    if kind == "coco":
        from slotdiffusion_tpu.data.coco import COCODataset
        return COCODataset(**kw)
    if kind == "voc":
        from slotdiffusion_tpu.data.voc import VOCDataset
        return VOCDataset(**kw)
    if kind == "movi":
        from slotdiffusion_tpu.data.movi import MOViDataset
        return MOViDataset(**kw)
    if kind == "physion":
        from slotdiffusion_tpu.data.physion import PhysionDataset
        return PhysionDataset(**kw)
    raise ValueError(kind)


def encode(arr):
    """-> (stored array, how `reference_files.decode` reads it back): a
    float image that is a uint8 code under one of the two normalisations,
    as the code; an integer array within uint8, as uint8."""
    arr = np.asarray(arr)
    if arr.dtype == np.float32 and arr.ndim >= 3 and arr.shape[-1] == 3:
        for how in ("u8fastio", "u8pil"):
            code = np.clip(np.rint(
                (arr + 1) * 127.5), 0, 255).astype(np.uint8)
            if np.array_equal(decode(code, how), arr):
                return code, how
    if arr.dtype.kind in "iu" and arr.size and arr.min() >= 0 and \
            arr.max() < 256:
        return arr.astype(np.uint8), f"int:{arr.dtype.str}"
    return arr, "raw"


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=osp.join(_REPO, "tests", "data",
                                              "torch_files"))
    args = ap.parse_args()
    from slotdiffusion_tpu.data import fastio
    if not fastio.fastio_available():
        raise SystemExit("the JAX package's native decode does not build: "
                         "its readers would take another path")
    if ImageFile.LOAD_TRUNCATED_IMAGES:
        raise SystemExit("PIL's LOAD_TRUNCATED_IMAGES is already set")
    if osp.isdir(args.out):
        shutil.rmtree(args.out)
    write_tree(args.out)
    os.environ["SLOTDIFFUSION_CACHE"] = tempfile.mkdtemp()
    import slotdiffusion_tpu.data.clevrtex as jct
    jct.CACHE_DIR = os.environ["SLOTDIFFUSION_CACHE"]
    from slotdiffusion_tpu.data.loader import SampleError
    refs, blobs, cases = {}, {}, []
    for name, kind, kw in CASES:
        if kind in ("movi", "physion") or ImageFile.LOAD_TRUNCATED_IMAGES:
            assert kind in ("movi", "physion"), f"{name} after MOVi"
        ds = jax_reader(kind, kw, args.out)
        cases.append(dict(name=name, reader=kind, kwargs=kw, items=len(ds)))
        for i in range(len(ds)):
            try:
                item = ds[i]
            except SampleError as e:
                refs[f"{name}/{i}/raises"] = np.array(
                    f"SampleError: {str(e).replace(args.out, '')}")
                continue
            for key, val in item.items():
                if key == "video":  # an alias of "img"
                    continue
                stored, how = encode(val)
                digest = hashlib.sha1(stored.tobytes() + str(
                    stored.shape).encode() + stored.dtype.str.encode()
                    ).hexdigest()[:16]
                blobs[f"blob/{digest}"] = stored
                refs[f"{name}/{i}/{key}"] = np.array(f"{digest}:{how}")
                assert np.array_equal(decode(stored, how), np.asarray(val))
    with open(osp.join(args.out, "cases.json"), "w") as f:
        json.dump(dict(truncated=TRUNCATED, recoded=RECODED, cases=cases),
                  f, indent=1)
    np.savez_compressed(osp.join(args.out, "references.npz"), **refs, **blobs)
    size = sum(osp.getsize(osp.join(d, f)) for d, _, fs in os.walk(args.out)
               for f in fs)
    print(f"wrote {len(cases)} reader cases, "
          f"{sum(c['items'] for c in cases)} items, {len(blobs)} distinct "
          f"arrays under {args.out}: {size / 1e6:.2f} MB")


if __name__ == "__main__":
    main()
