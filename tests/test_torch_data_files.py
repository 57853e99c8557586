"""The port's readers over the committed file tree `tests/data/torch_files/`
(written by `scripts/make_torch_data_fixture.py`) with PIL blocked, held
against what the JAX package's readers return for it (`references.npz`),
and the references held against the JAX readers as they read the tree
now, so the fixture cannot go stale.

Every item bit for bit: images, ids, masks, polygons and boxes (the
images are JPEG-derived through the port's own decoder, which gives
libjpeg-turbo's bits). The tree holds, recoded in place, a progressive
image for CelebA, COCO and VOC, progressive, arithmetic-coded and
arithmetic progressive MOVi frames, an interlaced ClevrTex image and
mask, and a 16-bit and a tRNS MOVi mask; each is checked to be in its
format. The MOVi mask cut to two thirds of its
bytes, which the port refused before it stopped decoding with PIL, gives
the JAX reader's clip in a process where PIL's truncation flag is off.
"""

import json
import os
import os.path as osp
import sys

import numpy as np
import pytest
from PIL import Image, ImageFile

from slotdiffusion_tpu_torch.data import reference_files as rf
from slotdiffusion_tpu_torch.data.loader import SampleError

ROOT = osp.join(osp.dirname(osp.abspath(__file__)), "data", "torch_files")
with open(osp.join(ROOT, "cases.json")) as _f:
    FIXTURE = json.load(_f)
CASES = {c["name"]: c for c in FIXTURE["cases"]}
STRICT = ("celeba", "clevrtex", "coco", "voc")


@pytest.fixture
def caches(tmp_path, monkeypatch):
    """Fresh split caches for both packages."""
    monkeypatch.setenv("SLOTDIFFUSION_CACHE", str(tmp_path / "cache"))
    import slotdiffusion_tpu.data.clevrtex as jct
    monkeypatch.setattr(jct, "CACHE_DIR", str(tmp_path / "jcache"))


@pytest.fixture
def no_pil(monkeypatch):
    """`import PIL` (and every PIL module) raises ImportError."""
    for name in [m for m in sys.modules if m == "PIL" or
                 m.startswith("PIL.")]:
        monkeypatch.setitem(sys.modules, name, None)
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError):
        import PIL.Image  # noqa: F401


@pytest.mark.parametrize("name", sorted(CASES))
def test_port_reader_equals_the_references_without_pil(name, caches,
                                                       no_pil):
    refs = rf.load_references(ROOT)
    res = rf.check_case(ROOT, CASES[name], refs)
    assert not res["failures"], res["failures"][:5]
    assert res["max_abs_err"] == 0.0
    assert res["items"] == CASES[name]["items"] > 0


def _jax_dataset(case):
    sys.path.insert(0, osp.join(osp.dirname(osp.dirname(osp.abspath(
        __file__))), "scripts"))
    from make_torch_data_fixture import jax_reader
    return jax_reader(case["reader"], case["kwargs"], ROOT)


@pytest.mark.parametrize("name", sorted(CASES))
def test_references_are_what_the_jax_readers_return(name, caches,
                                                    monkeypatch):
    """The JAX readers as a process of their own runs them: the strict ones
    with PIL's truncation flag off (the MOVi and Physion modules turn it
    on when imported)."""
    from slotdiffusion_tpu.data import fastio
    from slotdiffusion_tpu.data.loader import SampleError as JaxSampleError
    if not fastio.fastio_available():
        pytest.skip("the JAX package's native decode does not build here")
    case = CASES[name]
    if case["reader"] in STRICT:
        monkeypatch.setattr(ImageFile, "LOAD_TRUNCATED_IMAGES", False)
    refs = rf.load_references(ROOT)
    ds = _jax_dataset(case)
    assert len(ds) == case["items"]
    for i in range(len(ds)):
        keys = sorted(k.split("/")[2] for k in refs.files
                      if k.startswith(f"{name}/{i}/"))
        try:
            item = ds[i]
        except JaxSampleError:
            assert keys == ["raises"]
            continue
        assert keys == sorted(k for k in item if k != "video")
        for key in keys:
            ref = rf.reference(refs, name, i, key)
            got = np.asarray(item[key])
            assert got.dtype == ref.dtype and got.shape == ref.shape, key
            np.testing.assert_array_equal(got, ref, err_msg=f"{i} {key}")


def test_truncated_mask_reads_as_the_jax_reader_with_the_flag_off(
        caches, monkeypatch):
    """The mask of frame 2 of the first train video is cut to two thirds of
    its bytes. The JAX reader (whose module turns PIL's truncation flag on)
    decodes its whole rows; with the flag turned off again, PIL refuses
    the file, and the port still gives the JAX reader's clip."""
    from slotdiffusion_tpu.data.movi import MOViDataset as JaxMOVi
    from slotdiffusion_tpu_torch.data.movi import MOViDataset
    rel = "movi/MOVi-E/train/00000/000002_mask.png"
    assert FIXTURE["truncated"][rel] == pytest.approx(2 / 3)
    kw = dict(level="E", data_root=osp.join(ROOT, "movi"),
              resolution=(128, 128), split="train", n_sample_frames=6,
              load_mask=True)
    ref = JaxMOVi(**kw)[0]
    monkeypatch.setattr(ImageFile, "LOAD_TRUNCATED_IMAGES", False)
    with pytest.raises(OSError, match="truncated"):
        Image.open(osp.join(ROOT, rel)).load()
    got = MOViDataset(**kw)[0]
    np.testing.assert_array_equal(got["masks"], ref["masks"])
    np.testing.assert_array_equal(got["img"], ref["img"])
    # the cut mask keeps whole rows: some of frame 2's rows are zeros
    assert (got["masks"][2] == 0).all(1).any()


@pytest.mark.parametrize("where", ["signature", "palette", "idat_header",
                                   "image_data", "checksum"])
def test_voc_cut_mask_reads_as_the_jax_reader(tmp_path, caches, monkeypatch,
                                             where):
    """A VOC mask cut short, in a process where PIL's truncation flag is
    off (as the JAX VOC module leaves it). Where the file ends before its
    image data, the JAX reader's PIL `open` fails and it raises
    SampleError (the loader takes another index), and so does the port's;
    where the image data ends early, the JAX reader's lazy decode raises
    OSError at `np.asarray`, and so does the port's; cut in the zlib
    checksum, both read the whole mask."""
    import shutil
    from slotdiffusion_tpu.data.loader import SampleError as JaxSampleError
    from slotdiffusion_tpu.data.voc import VOCDataset as JaxVOC
    from slotdiffusion_tpu_torch.data import imageio
    from slotdiffusion_tpu_torch.data.voc import VOCDataset
    root = str(tmp_path / "voc")
    shutil.copytree(osp.join(ROOT, "voc"), root)
    kw = dict(data_root=root, resolution=(64, 64), split="val")
    mask = VOCDataset(**kw).semsegs[0]
    assert mask == JaxVOC(**kw).semsegs[0]
    with open(mask, "rb") as f:
        data = f.read()
    idat = data.index(b"IDAT") - 4  # the chunk's length field
    body = idat + 8
    n = int.from_bytes(data[idat:idat + 4], "big")
    cut = {"signature": 5, "palette": 100, "idat_header": body - 1,
           "image_data": body + n // 2, "checksum": body + n - 2}[where]
    with open(mask, "wb") as f:
        f.write(data[:cut])
    assert imageio.png_opens(data[:cut]) == (cut >= body)
    monkeypatch.setattr(ImageFile, "LOAD_TRUNCATED_IMAGES", False)
    if cut < body:
        with pytest.raises(JaxSampleError):
            JaxVOC(**kw)[0]
        with pytest.raises(SampleError):
            VOCDataset(**kw)[0]
    elif where == "image_data":
        with pytest.raises(OSError, match="truncated"):
            JaxVOC(**kw)[0]
        with pytest.raises(OSError, match="truncated"):
            VOCDataset(**kw)[0]
    else:
        ref, got = JaxVOC(**kw)[0], VOCDataset(**kw)[0]
        for key in ("masks", "inst_masks", "img"):
            np.testing.assert_array_equal(got[key], ref[key], err_msg=key)

def test_strict_readers_refuse_a_cut_file_and_the_loader_retries(
        caches, no_pil):
    """The CelebA test image is cut to half its bytes: the reader raises
    SampleError, as the JAX reader does, and the loader takes another
    index."""
    from slotdiffusion_tpu_torch.data.loader import fetch_with_retry
    ds = rf.build_reader(ROOT, CASES["celeba_test"])
    with pytest.raises(SampleError, match="truncated"):
        ds[0]
    both = rf.build_reader(ROOT, CASES["celeba_train"])
    both.files = ds.files + both.files
    item = fetch_with_retry(both, 0, seed=0)
    assert item["img"].shape == (128, 128, 3)


def _format(path):
    """A JPEG's SOF marker ("sof=0xc2") or a PNG's IHDR bit depth and
    interlace method, and whether it has a tRNS chunk."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:2] == b"\xff\xd8":  # walk the segments up to the frame
        pos = 2
        while data[pos + 1] not in (0xC0, 0xC1, 0xC2, 0xC9, 0xCA):
            pos += 2 + int.from_bytes(data[pos + 2:pos + 4], "big")
        return "sof=" + hex(data[pos + 1])
    return (f"depth={data[24]} interlace={data[28]} "
            f"trns={b'tRNS' in data}")


FORMATS = {"progressive": "sof=0xc2", "progressive_transcoded": "sof=0xc2",
           "arithmetic": "sof=0xc9",
           "arithmetic_progressive": "sof=0xca",
           "adam7": "depth=8 interlace=1 trns=False",
           "16bit": "depth=16 interlace=0 trns=False",
           "trns": "depth=8 interlace=0 trns=True"}


@pytest.mark.parametrize("rel", sorted(FIXTURE["recoded"]))
def test_the_fixture_holds_each_recoded_format(rel):
    assert _format(osp.join(ROOT, rel)) == FORMATS[FIXTURE["recoded"][rel]]


def test_the_fixture_is_small_and_its_cut_files_are_cut(monkeypatch):
    size = sum(osp.getsize(osp.join(d, f)) for d, _, fs in os.walk(ROOT)
               for f in fs)
    assert size < 2.5e6, size
    kinds = {osp.splitext(rel)[1] for rel in FIXTURE["truncated"]}
    assert kinds == {".png", ".jpg"}
    monkeypatch.setattr(ImageFile, "LOAD_TRUNCATED_IMAGES", False)
    for rel in FIXTURE["truncated"]:
        with pytest.raises(OSError, match="truncated"):
            Image.open(osp.join(ROOT, rel)).load()


def test_the_port_imports_no_pil():
    """No `import PIL` / `from PIL ...` statement in the port's package,
    `chip_smoke.py` or the port's scripts: the card runs without it."""
    import ast
    import glob
    repo = osp.dirname(osp.dirname(osp.abspath(__file__)))
    files = glob.glob(osp.join(repo, "slotdiffusion_tpu_torch", "**",
                               "*.py"), recursive=True)
    files += glob.glob(osp.join(repo, "scripts", "*_torch.py"))
    files.append(osp.join(repo, "chip_smoke.py"))
    found = []
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            names = [a.name for a in node.names] if isinstance(
                node, ast.Import) else [node.module or ""] if isinstance(
                node, ast.ImportFrom) else []
            found += [f"{osp.relpath(path, repo)}:{node.lineno}"
                      for n in names if n == "PIL" or n.startswith("PIL.")]
    assert len(files) > 60 and not found, found
