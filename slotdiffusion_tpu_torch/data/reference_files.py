"""The port's readers over a committed file tree, held against what the
JAX package's readers return for it (`scripts/make_torch_data_fixture.py`
writes both: the tree, `cases.json` naming each reader's arguments, and
`references.npz`).

`check_case(root, case, refs)` reads every item of one case with the
port's reader and compares it with the references: integer arrays and
images bit for bit (`max_abs_err` 0), an item the JAX reader refused with
`SampleError` refused the same way.
"""

import json
import os.path as osp

import numpy as np

from .loader import SampleError


def load_cases(root):
    with open(osp.join(root, "cases.json")) as f:
        return json.load(f)


def load_references(root):
    return np.load(osp.join(root, "references.npz"))


def build_reader(root, case):
    """The port's dataset for one case of `cases.json`."""
    kw = dict(case["kwargs"])
    kw["data_root"] = osp.join(root, kw["data_root"])
    kw["resolution"] = tuple(kw["resolution"])
    kind = case["reader"]
    if kind == "celeba":
        from .celeba import CelebADataset as cls
    elif kind == "clevrtex":
        from .clevrtex import CLEVRTexDataset as cls
    elif kind == "coco":
        from .coco import COCODataset as cls
    elif kind == "voc":
        from .voc import VOCDataset as cls
    elif kind == "movi":
        from .movi import MOViDataset as cls
    elif kind == "physion":
        from .physion import PhysionDataset as cls
    else:
        raise ValueError(f"unknown reader {kind!r}")
    return cls(**kw)


def reference(refs, name, idx, key):
    """The JAX reader's array for one item's key."""
    digest, how = str(refs[f"{name}/{idx}/{key}"]).split(":", 1)
    return decode(refs[f"blob/{digest}"], how)


def decode(stored, how):
    """A stored array back as the reader returned it: "u8fastio" and
    "u8pil" are uint8 codes of float images under the JAX native decode's
    normalisation (code * (1 / 127.5) - 1 in float32) and PIL's ((code /
    255 - 0.5) / 0.5 in numpy float32); "int:<dtype>" an integer array
    stored as uint8; "raw" as it is."""
    if how == "u8fastio":
        return stored.astype(np.float32) * np.float32(1.0 / 127.5) + \
            np.float32(-1.0)
    if how == "u8pil":
        return (np.asarray(stored, np.float32) / 255.0 - 0.5) / 0.5
    if how.startswith("int:"):
        return stored.astype(np.dtype(how[4:]))
    return stored


def check_case(root, case, refs):
    """-> dict(items, arrays, max_abs_err, failures): every item of one
    case read by the port against the references. A failure names the
    item and key (a missing key, a shape or dtype that differs, values
    that differ, or a refusal on one side only)."""
    name = case["name"]
    ds = build_reader(root, case)
    out = dict(items=len(ds), arrays=0, max_abs_err=0.0, failures=[])
    if len(ds) != case["items"]:
        out["failures"].append(f"{name}: {len(ds)} items, the JAX reader "
                               f"has {case['items']}")
        return out
    prefix = f"{name}/"
    for i in range(len(ds)):
        keys = [k[len(f"{prefix}{i}/"):] for k in refs.files
                if k.startswith(f"{prefix}{i}/")]
        try:
            item = ds[i]
        except SampleError as e:
            if keys != ["raises"]:
                out["failures"].append(f"{name}[{i}]: the port refused it "
                                       f"({e}), the JAX reader did not")
            continue
        if keys == ["raises"]:
            out["failures"].append(f"{name}[{i}]: the JAX reader refused it, "
                                   "the port did not")
            continue
        for key in keys:
            ref = reference(refs, name, i, key)
            if key not in item:
                out["failures"].append(f"{name}[{i}].{key}: missing")
                continue
            got = np.asarray(item[key])
            out["arrays"] += 1
            if got.shape != ref.shape or got.dtype != ref.dtype:
                out["failures"].append(
                    f"{name}[{i}].{key}: {got.dtype}{list(got.shape)} vs "
                    f"{ref.dtype}{list(ref.shape)}")
                continue
            if got.size:
                err = float(np.abs(got.astype(np.float64) -
                                   ref.astype(np.float64)).max())
                out["max_abs_err"] = max(out["max_abs_err"], err)
            if not np.array_equal(got, ref):
                out["failures"].append(f"{name}[{i}].{key}: values differ")
    return out
