"""PASCAL VOC 2012 (an own copy of the JAX package's data/voc.py:26-134,
which follows upstream img_based/datasets/voc.py): images listed by
`sets/{split}.txt` (or `ImageSets/Segmentation/`), semantic masks from
SegmentationClassAug (trainaug) or SegmentationClass, instance masks from
SegmentationObject (val only). Resize so the image covers the
resolution, crop (random at train, centred at val; one draw for the
image and its masks), flip at train, images to [-1, 1]; the palettized
masks' 255 void ring becomes background, instance ids are made
consecutive. The files decode, resize, crop and flip as PIL does them
for the JAX dataset (`data/imageio.py`; the masks' palette indices kept).
An image that cannot be read, or whose data ends early, raises
`SampleError`; a mask file that is missing, or that ends before its
image data, does too (where the JAX dataset's PIL `open` fails), while a
mask whose image data ends early raises OSError, as the JAX dataset's
lazy PIL decode does.
"""

import os.path as osp

import numpy as np
from torch.utils.data import Dataset

from . import imageio
from .loader import SampleError
from .transforms import suppress_mask_idx

VOC_CATEGORY_NAMES = [
    "background", "aeroplane", "bicycle", "bird", "boat", "bottle", "bus",
    "car", "cat", "chair", "cow", "diningtable", "dog", "horse", "motorbike",
    "person", "pottedplant", "sheep", "sofa", "train", "tvmonitor",
]


class VOCDataset(Dataset):
    """Sample: img [-1,1], masks (semantic, int), inst_masks (instance,
    suppressed ids) for val."""

    def __init__(self, data_root, resolution, split="trainaug",
                 load_anno=True):
        assert split in ("trainaug", "train", "val")
        self.split = split
        self.resolution = tuple(resolution)
        self.load_anno = load_anno
        sem_dir = osp.join(
            data_root,
            "SegmentationClassAug" if split == "trainaug"
            else "SegmentationClass")
        inst_dir = osp.join(data_root, "SegmentationObject")
        img_dir = osp.join(data_root, "images")
        if not osp.isdir(img_dir):
            img_dir = osp.join(data_root, "JPEGImages")
        split_file = osp.join(data_root, "sets", split + ".txt")
        if not osp.isfile(split_file):
            split_file = osp.join(data_root, "ImageSets", "Segmentation",
                                  split + ".txt")
        with open(split_file) as f:
            names = [l.strip() for l in f if l.strip()]
        self.images = [osp.join(img_dir, n + ".jpg") for n in names]
        self.semsegs = [osp.join(sem_dir, n + ".png") for n in names]
        self.instsegs = [
            osp.join(inst_dir if split == "val" else sem_dir, n + ".png")
            for n in names
        ]

    def __len__(self):
        return len(self.images)

    def __getitem__(self, idx):
        rng = np.random.RandomState(idx) if self.split != "val" else None
        try:
            img = imageio.read_image(self.images[idx]).convert("RGB").array
        except (FileNotFoundError, OSError) as e:
            raise SampleError(str(e))
        img = imageio.resize_to_cover(img, self.resolution)
        # pick crop offsets / flip ONCE so image and masks stay aligned
        h, w = self.resolution
        H, W = img.shape[:2]
        if rng is None:
            top, left = (H - h) // 2, (W - w) // 2
            flip = False
        else:
            top = rng.randint(0, max(H - h, 0) + 1)
            left = rng.randint(0, max(W - w, 0) + 1)
            flip = rng.rand() < 0.5
        box = (left, top, left + w, top + h)
        img = imageio.crop(img, box)
        if flip:
            img = imageio.flip_left_right(img)
        arr = (np.asarray(img, np.float32) / 255.0 - 0.5) / 0.5
        out = {"data_idx": np.int32(idx), "img": arr}
        if self.load_anno:
            out["masks"] = self._load_mask(self.semsegs[idx], box, flip,
                                           suppress=False)
            if self.split == "val":
                out["inst_masks"] = self._load_mask(
                    self.instsegs[idx], box, flip, suppress=True)
        return out

    def _load_mask(self, path, box, flip, suppress):
        try:
            with open(path, "rb") as f:
                data = f.read()
        except (FileNotFoundError, OSError) as e:
            raise SampleError(str(e))
        if not imageio.png_opens(data):  # where PIL's open fails
            raise SampleError(f"{path}: the file ends before its image data")
        m = imageio.decode_png(data, name=path).array
        m = imageio.resize_to_cover(m, self.resolution, nearest=True)
        m = imageio.crop(m, box)
        if flip:
            m = imageio.flip_left_right(m)
        arr = np.asarray(m, np.int32).copy()
        arr[arr == 255] = 0  # ignore label -> background
        if suppress:
            arr = suppress_mask_idx(arr)
        return arr


def build_voc_dataset(params, val_only=False):
    """-> the val set (`val_only`), or (train set, val set)."""
    kw = dict(data_root=params.data_root, resolution=params.resolution,
              load_anno=getattr(params, "load_anno", True))
    val = VOCDataset(split="val", **kw)
    if val_only:
        return val
    return VOCDataset(split=getattr(params, "train_split", "trainaug"),
                      **kw), val
