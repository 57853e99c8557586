"""Synthetic images and video clips for training without data on disk
(own numpy copies of the JAX package's data/synthetic.py:18-72
`SyntheticImageDataset`, :75-142 `SyntheticCOCODataset` and :145-189
`SyntheticVideoDataset`): squares
and discs of random colours over a gradient background (images), or
squares drifting with constant velocity over a dark background (clips);
`img` in [-1, 1] as [H, W, 3] or [T, H, W, 3] and the object ids as
`masks` [H, W] or [T, H, W] (with `load_mask`), every sample a function
of (seed, index), bit-identical to the JAX dataset's. The COCO-shaped
images carry COCO's sample layout (semantic `masks`, `inst_masks`,
`overlap_masks`, `annos`), so the dual inst/sem protocol runs with no
data on disk.

`SyntheticVideoData` batches them through `data.loader.DataModule`, in
the order of the JAX package's loader: a permutation seeded by
`seed + epoch`, whole batches only; with `val_samples`, a val set of
seed `seed + 1`.
"""

import numpy as np
from torch.utils.data import Dataset

from .loader import DataModule
from .transforms import suppress_mask_idx


def _render_scene(rng, resolution, max_objects=4):
    """A gradient background and 1..`max_objects` coloured squares or
    discs; -> (img float32 [H, W, 3] in [0, 1], mask int32 [H, W])."""
    H, W = resolution
    gy = np.linspace(0, 1, H)[:, None]
    gx = np.linspace(0, 1, W)[None, :]
    bg_color = rng.rand(3) * 0.4
    img = np.zeros((H, W, 3), np.float32)
    for c in range(3):
        img[..., c] = bg_color[c] + 0.2 * (gy * rng.rand() + gx * rng.rand())
    mask = np.zeros((H, W), np.int32)
    n_obj = rng.randint(1, max_objects + 1)
    ys, xs = np.mgrid[0:H, 0:W]
    for i in range(n_obj):
        color = 0.4 + 0.6 * rng.rand(3)
        size = rng.randint(max(H // 8, 3), max(H // 3, 5))
        cy = rng.randint(0, H)
        cx = rng.randint(0, W)
        if rng.rand() < 0.5:  # square
            sel = (np.abs(ys - cy) < size // 2) & (np.abs(xs - cx) < size // 2)
        else:  # disc
            sel = (ys - cy) ** 2 + (xs - cx) ** 2 < (size // 2) ** 2
        img[sel] = color
        mask[sel] = i + 1
    return np.clip(img, 0.0, 1.0), mask


class SyntheticImageDataset(Dataset):
    """{"img": float32 [H, W, 3] in [-1, 1], "masks": int32 [H, W] (with
    `load_mask`), "data_idx"}, the CLEVRTex sample's layout."""

    def __init__(self, resolution=(64, 64), num_samples=128, max_objects=4,
                 load_mask=True, seed=0):
        self.resolution = tuple(resolution)
        self.num_samples = num_samples
        self.max_objects = max_objects
        self.load_mask = load_mask
        self.seed = seed

    def __len__(self):
        return self.num_samples

    def __getitem__(self, idx):
        rng = np.random.RandomState(self.seed * 100003 + idx)
        img, mask = _render_scene(rng, self.resolution, self.max_objects)
        out = {"img": (img * 2.0 - 1.0).astype(np.float32),
               "data_idx": np.int32(idx)}
        if self.load_mask:
            out["masks"] = mask
        return out


def synthetic_image_splits(params):
    """The JAX builder's "synthetic" splits (data/builders.py:14-28): train
    (seed 0, `train_samples`, 512 by default) and val (seed 1,
    `val_samples`, 64) at the config's resolution, with its `max_objects`
    (4) and `load_mask` (True)."""
    kw = dict(resolution=tuple(params.resolution),
              max_objects=getattr(params, "max_objects", 4),
              load_mask=getattr(params, "load_mask", True))
    return (SyntheticImageDataset(
                num_samples=getattr(params, "train_samples", 512), seed=0,
                **kw),
            SyntheticImageDataset(
                num_samples=getattr(params, "val_samples", 64), seed=1,
                **kw))


class SyntheticCOCODataset(Dataset):
    """COCO-shaped synthetic images with `COCODataset`'s sample layout:
    {"img", "masks" (semantic: 1 a square, 2 a disc), "inst_masks" (the
    painting order's ids, made consecutive), "overlap_masks" (pixels
    painted more than once), "annos" [N, 5] (x1, y1, x2, y2, label 0 a
    square, 1 a disc), "data_idx"}; batch it with `coco_collate_fn`."""

    def __init__(self, resolution=(64, 64), num_samples=64, max_objects=4,
                 load_anno=True, seed=0):
        self.resolution = tuple(resolution)
        self.num_samples = num_samples
        self.max_objects = max_objects
        self.load_anno = load_anno
        self.seed = seed

    def __len__(self):
        return self.num_samples

    def __getitem__(self, idx):
        rng = np.random.RandomState(self.seed * 100003 + idx)
        H, W = self.resolution
        gy = np.linspace(0, 1, H)[:, None]
        gx = np.linspace(0, 1, W)[None, :]
        bg_color = rng.rand(3) * 0.4
        img = np.zeros((H, W, 3), np.float32)
        for c in range(3):
            img[..., c] = bg_color[c] + 0.2 * (gy * rng.rand()
                                               + gx * rng.rand())
        inst = np.zeros((H, W), np.int32)
        sem = np.zeros((H, W), np.int32)
        paint_count = np.zeros((H, W), np.int32)
        n_obj = rng.randint(1, self.max_objects + 1)
        ys, xs = np.mgrid[0:H, 0:W]
        boxes = []
        for _ in range(n_obj):
            color = 0.4 + 0.6 * rng.rand(3)
            size = rng.randint(max(H // 8, 3), max(H // 3, 5))
            cy = rng.randint(0, H)
            cx = rng.randint(0, W)
            square = rng.rand() < 0.5
            if square:
                sel = (np.abs(ys - cy) < size // 2) & \
                      (np.abs(xs - cx) < size // 2)
            else:
                sel = (ys - cy) ** 2 + (xs - cx) ** 2 < (size // 2) ** 2
            if not sel.any():
                continue
            img[sel] = color
            inst[sel] = len(boxes) + 1  # a later object overwrites
            sem[sel] = 1 if square else 2
            paint_count[sel] += 1
            sy, sx = np.nonzero(sel)
            boxes.append([sx.min(), sy.min(), sx.max() + 1, sy.max() + 1,
                          0 if square else 1])
        out = {"data_idx": np.int32(idx),
               "img": (np.clip(img, 0, 1) * 2.0 - 1.0).astype(np.float32)}
        if self.load_anno:
            out["masks"] = sem
            out["inst_masks"] = suppress_mask_idx(inst)
            out["overlap_masks"] = (paint_count > 1).astype(np.int32)
            out["annos"] = np.asarray(boxes, np.float32).reshape(-1, 5)
        return out


def synthetic_coco_splits(params):
    """The JAX builder's "synthetic_coco" splits (data/builders.py:45-57):
    train (seed 0, `train_samples`, 512 by default) and val (seed 1,
    `val_samples`, 64) at the config's resolution, with its
    `max_objects` (4) and `load_anno` (True)."""
    kw = dict(resolution=tuple(params.resolution),
              max_objects=getattr(params, "max_objects", 4),
              load_anno=getattr(params, "load_anno", True))
    return (SyntheticCOCODataset(
                num_samples=getattr(params, "train_samples", 512), seed=0,
                **kw),
            SyntheticCOCODataset(
                num_samples=getattr(params, "val_samples", 64), seed=1,
                **kw))


class SyntheticVideoDataset(Dataset):
    def __init__(self, resolution=(64, 64), num_samples=64,
                 n_sample_frames=3, max_objects=4, load_mask=True, seed=0):
        self.resolution = tuple(resolution)
        self.num_samples = num_samples
        self.n_frames = n_sample_frames
        self.max_objects = max_objects
        self.load_mask = load_mask
        self.seed = seed

    def __len__(self):
        return self.num_samples

    def __getitem__(self, idx):
        rng = np.random.RandomState(self.seed * 100003 + idx)
        H, W = self.resolution
        n_obj = rng.randint(1, self.max_objects + 1)
        colors = 0.4 + 0.6 * rng.rand(n_obj, 3)
        sizes = rng.randint(max(H // 8, 3), max(H // 3, 5), size=n_obj)
        pos = rng.rand(n_obj, 2) * [H, W]
        vel = (rng.rand(n_obj, 2) - 0.5) * H * 0.1
        bg_color = rng.rand(3) * 0.4
        ys, xs = np.mgrid[0:H, 0:W]
        frames, masks = [], []
        for t in range(self.n_frames):
            img = np.tile(bg_color[None, None].astype(np.float32), (H, W, 1))
            mask = np.zeros((H, W), np.int32)
            for i in range(n_obj):
                cy, cx = pos[i] + vel[i] * t
                sel = (np.abs(ys - cy) < sizes[i] // 2) & \
                      (np.abs(xs - cx) < sizes[i] // 2)
                img[sel] = colors[i]
                mask[sel] = i + 1
            frames.append(np.clip(img, 0, 1))
            masks.append(mask)
        out = {
            "img": (np.stack(frames) * 2.0 - 1.0).astype(np.float32),
            "data_idx": np.int32(idx),
        }
        if self.load_mask:
            out["masks"] = np.stack(masks)
        return out


def synthetic_video_splits(params, num_samples=256, val_samples=32,
                           seed=0):
    """The train split (seed `seed`) and, with `val_samples`, the val
    split (seed `seed + 1`, else None) at a config's resolution and clip
    length, with its `max_objects` (4) and `load_mask` (True). The
    defaults are the JAX builder's for "synthetic_video"."""
    kw = dict(resolution=tuple(params.resolution),
              n_sample_frames=params.n_sample_frames,
              max_objects=getattr(params, "max_objects", 4),
              load_mask=getattr(params, "load_mask", True))
    train = SyntheticVideoDataset(num_samples=num_samples, seed=seed, **kw)
    val = SyntheticVideoDataset(num_samples=val_samples, seed=seed + 1,
                                **kw) if val_samples else None
    return train, val


class SyntheticVideoData(DataModule):
    """Synthetic clips at a config's resolution and clip length: the
    train split (seed `seed`) in batches of `batch_size` and, with
    `val_samples`, a val split (seed `seed + 1`)."""

    def __init__(self, params, batch_size, num_samples=256, seed=0,
                 val_samples=0):
        train, val = synthetic_video_splits(params, num_samples,
                                            val_samples, seed)
        super().__init__(train, val, batch_size, seed=seed)
