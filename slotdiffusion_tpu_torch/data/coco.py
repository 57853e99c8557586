"""COCO 2017 (an own copy of the JAX package's data/coco.py:45-193, which
follows upstream img_based/datasets/coco.py): instance and semantic
segmentation with box annotations.

- instance masks painted in annotation order (a later one overwrites),
  and the overlap mask of the pixels covered by more than one instance
  (the DINOSAUR protocol takes them out of every metric);
- semantic masks painted with the category's label + 1 (0 is the
  background);
- boxes [N, 5] = (x1, y1, x2, y2, label), crowd, ignored and degenerate
  ones left out;
- resize so the image covers the resolution, crop (random at train,
  centred at val), flip at train (random by (epoch, index): `set_epoch`),
  images to [-1, 1]; masks resized nearest;
- `coco_collate_fn` pads the boxes to the batch's longest with -1 rows.

The images decode, convert and resize as PIL does them for the JAX
dataset (`data/imageio.py`; grayscale and CMYK JPEGs to RGB as
`convert("RGB")` turns them); pycocotools reads the annotations where it
is installed, `_coco_api.MiniCOCO` otherwise. A file that cannot be
read, or whose data ends early, raises `SampleError`.
"""

import os.path as osp

import numpy as np
import torch
from torch.utils.data import Dataset, default_collate

from . import imageio
from .loader import SampleError
from .transforms import suppress_mask_idx


class COCODataset(Dataset):
    """Sample keys: img [-1,1] f32, masks (semantic int), inst_masks
    (instance, id-suppressed), overlap_masks (binary), annos [N, 5]."""

    def __init__(self, data_root, resolution, split="val", load_anno=True):
        try:
            from pycocotools.coco import COCO
        except ImportError:  # the same JSON format, read here
            from ._coco_api import MiniCOCO as COCO

        assert split in ("train", "val")
        self.split = split
        self.resolution = tuple(resolution)
        self.epoch = 0  # advanced by DataLoader.set_epoch
        self.load_anno = load_anno
        self.image_dir = osp.join(data_root, f"{split}2017")
        anno_file = osp.join(
            data_root, "annotations", f"instances_{split}2017.json")
        self.coco = COCO(anno_file)
        self.image_ids = sorted(self.coco.getImgIds())
        self.cat_ids = sorted(self.coco.getCatIds())
        self.cat_id_to_label = {c: i for i, c in enumerate(self.cat_ids)}

    def set_epoch(self, epoch: int):
        """Fresh augmentation randomness every epoch (the upstream
        RandomCrop/RandomHorizontalFlip draw per call)."""
        self.epoch = int(epoch)

    def __len__(self):
        return len(self.image_ids)

    def _valid_annos(self, idx):
        annos = self.coco.loadAnns(
            self.coco.getAnnIds(imgIds=self.image_ids[idx]))
        out = []
        for anno in annos:
            if anno.get("ignore", False) or anno.get("iscrowd", False):
                continue
            if anno["category_id"] not in self.cat_id_to_label:
                continue
            out.append(anno)
        return out

    def __getitem__(self, idx):
        info = self.coco.loadImgs(self.image_ids[idx])[0]
        path = osp.join(self.image_dir, info["file_name"])
        try:
            img = imageio.read_image(path).convert("RGB").array
        except (FileNotFoundError, OSError) as e:
            raise SampleError(str(e))
        H, W = img.shape[:2]

        annos = self._valid_annos(idx) if self.load_anno else []
        inst = np.zeros((H, W), np.int32)
        overlap = np.zeros((H, W), np.int32)
        sem = np.zeros((H, W), np.int32)
        boxes = np.zeros((0, 5), np.float32)
        for i, anno in enumerate(annos):
            m = self.coco.annToMask(anno) > 0
            inst[m] = i + 1
            overlap[m] += 1
            sem[m] = self.cat_id_to_label[anno["category_id"]] + 1
            x, y, w, h = anno["bbox"]
            iw = max(0, min(x + w, W) - max(x, 0))
            ih = max(0, min(y + h, H) - max(y, 0))
            if iw * ih == 0 or w * h < 1 or w < 1 or h < 1:
                continue
            boxes = np.append(boxes, [[
                x, y, x + w, y + h,
                self.cat_id_to_label[anno["category_id"]]]], axis=0)
        overlap = (overlap > 1).astype(np.int32)

        # joint geometric transform
        res = self.resolution
        rng = np.random.RandomState(
            (self.epoch * 1000003 + idx * 7919 + 17) & 0x7FFFFFFF) \
            if self.split == "train" else None
        img = imageio.resize_to_cover(img, res)
        inst = imageio.resize_to_cover(inst, res, nearest=True)
        overlap = imageio.resize_to_cover(overlap, res, nearest=True)
        sem = imageio.resize_to_cover(sem, res, nearest=True)
        Hs, Ws = img.shape[:2]
        h, w = res
        if rng is None:
            top, left = (Hs - h) // 2, (Ws - w) // 2
            flip = False
        else:
            top = rng.randint(0, max(Hs - h, 0) + 1)
            left = rng.randint(0, max(Ws - w, 0) + 1)
            flip = rng.rand() < 0.5
        sl = (slice(top, top + h), slice(left, left + w))
        img, inst, overlap, sem = img[sl], inst[sl], overlap[sl], sem[sl]
        scale = max(h / H, w / W)
        if len(boxes):
            boxes[:, :4] = boxes[:, :4] * scale
            boxes[:, [0, 2]] -= left
            boxes[:, [1, 3]] -= top
        if flip:
            img, inst = img[:, ::-1], inst[:, ::-1]
            overlap, sem = overlap[:, ::-1], sem[:, ::-1]
            if len(boxes):
                x1 = boxes[:, 0].copy()
                boxes[:, 0] = w - boxes[:, 2]
                boxes[:, 2] = w - x1
        if len(boxes):
            # clip to the crop window (the upstream CenterCrop clips annos
            # to [0, resolution]) and drop boxes left with zero area
            boxes[:, [0, 2]] = boxes[:, [0, 2]].clip(0, w)
            boxes[:, [1, 3]] = boxes[:, [1, 3]].clip(0, h)
            keep = (boxes[:, 2] > boxes[:, 0]) & (boxes[:, 3] > boxes[:, 1])
            boxes = boxes[keep]

        out = {
            "data_idx": np.int32(idx),
            "img": (img.astype(np.float32) / 255.0 - 0.5) / 0.5,
        }
        if self.load_anno:
            out["masks"] = np.ascontiguousarray(sem)
            out["inst_masks"] = suppress_mask_idx(
                np.ascontiguousarray(inst))
            out["overlap_masks"] = np.ascontiguousarray(overlap)
            out["annos"] = boxes.astype(np.float32)
        return out


def coco_collate_fn(samples):
    """Pad the variable-length `annos` to the batch's longest with -1 rows
    (upstream's COCOCollater); everything else is torch's default
    collate. -> a dict of tensors."""
    samples = [dict(s) for s in samples]
    annos = [s.pop("annos", None) for s in samples]
    batch = default_collate(samples)
    if annos[0] is not None:
        n_max = max(1, max(a.shape[0] for a in annos))
        padded = np.full((len(annos), n_max, 5), -1.0, np.float32)
        for i, a in enumerate(annos):
            padded[i, :a.shape[0]] = a
        batch["annos"] = torch.from_numpy(padded)
    return batch


def build_coco_dataset(params, val_only=False):
    """-> the val set (`val_only`), or (train set, val set); batch them
    with `coco_collate_fn`."""
    kw = dict(data_root=params.data_root, resolution=params.resolution,
              load_anno=getattr(params, "load_anno", True))
    val = COCODataset(split="val", **kw)
    if val_only:
        return val
    return COCODataset(split="train", **kw), val
