"""CLEVRTex (an own copy of the JAX package's data/clevrtex.py:26-125):
`CLEVRTEX_<variant>_*.png` images with `_flat.png` id masks under
`clevrtex_<variant>/`, both center-cropped to 192 pixels, then resized;
the split by index fraction of the sorted list, test/val/train =
0.1/0.1/0.8; with `max_obj` > 0 only scenes with at most that many
objects. Each sample is {"img": [H, W, 3] in [-1, 1], "masks": [H, W]
ids made consecutive (with `load_mask`), "data_idx"}. The index is
cached (as JSON) under `utils.cache_dir()`, keyed by the root and
`max_obj`. A file that cannot be read, or whose data ends early, raises
`SampleError`, so the loader tries another image. The PNGs decode,
crop and resize as PIL does them for the JAX dataset (`data/imageio.py`).
"""

import glob
import hashlib
import os.path as osp

import numpy as np
from torch.utils.data import Dataset

from ..utils import cache_dir, dump_obj, load_obj
from . import imageio
from .loader import SampleError
from .transforms import BaseTransforms, suppress_mask_idx

SPLIT_FRACTIONS = {"test": (0.0, 0.1), "val": (0.1, 0.2), "train": (0.2, 1.0)}


def _center_crop(arr, crop):
    H, W = arr.shape[:2]
    return imageio.crop(arr, ((W - crop) // 2, (H - crop) // 2,
                              (W + crop) // 2, (H + crop) // 2))


class CLEVRTexDataset(Dataset):

    def __init__(self, data_root, resolution, split="train", variant="full",
                 crop=192, load_mask=True, max_obj=-1):
        self.transforms = BaseTransforms(resolution)
        self.split = split
        self.crop = crop
        self.load_mask = load_mask
        self.max_obj = max_obj
        self.variant = variant
        base, sub = data_root, f"clevrtex_{variant}"
        if osp.basename(osp.normpath(base)) != sub:
            base = osp.join(base, sub)
        if not osp.isdir(base):
            raise FileNotFoundError(f"CLEVRTex not found at {base}")
        self.basepath = base
        self.img_index, self.msk_index = self._build_index()
        n = len(self.img_index)
        lo, hi = SPLIT_FRACTIONS[split]
        self.bias, self.limit = int(lo * n), int(hi * n)

    def _build_index(self):
        tag = hashlib.md5(osp.abspath(self.basepath).encode()).hexdigest()
        cache = osp.join(cache_dir(), "splits", "CLEVRTex",
                         f"{self.variant}-{tag[:8]}",
                         f"index-max_{self.max_obj}.json")
        if osp.isfile(cache):
            d = load_obj(cache)
            return d["img"], d["msk"]
        prefix = f"CLEVRTEX_{self.variant}_"
        imgs = sorted(glob.glob(osp.join(self.basepath, "**",
                                         f"{prefix}*[0-9].png"),
                                recursive=True))
        imgs = [p for p in imgs if not p.endswith("_flat.png")
                and "_depth" not in p and "_albedo" not in p]
        img_index, msk_index = [], []
        for p in imgs:
            m = p[:-4] + "_flat.png"
            if not osp.isfile(m):
                continue
            if self.max_obj > 0:
                msk = _center_crop(imageio.read_image(m).array, self.crop)
                if np.unique(msk).shape[0] > self.max_obj + 1:
                    continue
            img_index.append(p)
            msk_index.append(m)
        if not img_index:
            raise FileNotFoundError(f"no CLEVRTex images in {self.basepath}")
        dump_obj({"img": img_index, "msk": msk_index}, cache)
        return img_index, msk_index

    def __len__(self):
        return self.limit - self.bias

    def __getitem__(self, idx):
        idx = idx + self.bias
        try:
            img = self.transforms.read_rgb(self.img_index[idx])
            if self.crop > 0:
                img = _center_crop(img, self.crop)
            out = {"data_idx": np.int32(idx),
                   "img": self.transforms(img).astype(np.float32)}
            if self.load_mask:
                msk = imageio.read_image(self.msk_index[idx]).array
                if self.crop > 0:
                    msk = _center_crop(msk, self.crop)
                mask = self.transforms.process_mask(msk)
                out["masks"] = suppress_mask_idx(mask)
            return out
        except (FileNotFoundError, OSError) as e:
            raise SampleError(str(e))


def build_clevrtex_dataset(params, val_only=False):
    """-> the test split (`val_only`), or (train, val)."""
    kw = dict(data_root=params.data_root, resolution=params.resolution,
              load_mask=params.load_mask,
              max_obj=getattr(params, "max_obj", -1))
    val = CLEVRTexDataset(split="test" if val_only else "val", **kw)
    if val_only:
        return val
    return CLEVRTexDataset(split="train", **kw), val
