"""MOVi video datasets (an own copy of the JAX package's data/movi.py:
33-205): frame-folder videos
`{data_root}/MOVi-{L}/{split}/{video}/{frame:06d}.jpg` with grayscale id
masks `{frame:06d}_mask.png`, or, in the STEVE-MOVi layout of MOVi-Solid
and -Tex (`dataset="steve_movi"`), `{frame:08d}_image.png` with 10
per-object binary masks `{frame:08d}_mask_{k:02d}.png`, merged by argmax
over a background at id 0, and no validation split (the test split
stands in).

Clips per split: train, every valid start index; validation, strided
non-overlapping clips; test, one clip a video. Each sample is
{"img": [T, H, W, 3] in [-1, 1], "masks": [T, H, W] int32 ids made
consecutive (with `load_mask`), "data_idx"}; `load_video` switches to
whole videos. A split's folder list is cached (as JSON) under
`SLOTDIFFUSION_CACHE`, by default `.cache/slotdiffusion_tpu_torch/` in the
repo. A frame that cannot be read raises `SampleError`, so the loader
tries another clip. A frame or mask whose data ends early is read as
the JAX reader reads it (that module sets PIL's
`ImageFile.LOAD_TRUNCATED_IMAGES`): a JPEG as libjpeg decodes a stream
that ends early, a PNG with its whole rows and zeros after them.
"""

import hashlib
import os.path as osp

import numpy as np
from torch.utils.data import Dataset

from ..utils import cache_dir, dump_obj, glob_all, load_obj
from . import imageio
from .loader import SampleError
from .transforms import BaseTransforms, suppress_mask_idx


class MOViDataset(Dataset):
    # per-object binary masks a frame in the STEVE-MOVi layout
    NUM_STEVE_MASKS = 10

    def __init__(self, level, data_root, resolution, split="train",
                 n_sample_frames=6, frame_offset=1, video_len=24,
                 load_mask=False, layout="movi"):
        if layout not in ("movi", "steve_movi"):
            raise ValueError(f"unknown MOVi layout {layout!r}")
        if split == "val":
            split = "validation"
        if layout == "steve_movi" and split == "validation":
            split = "test"
        if split not in ("train", "validation", "test"):
            raise ValueError(f"unknown MOVi split {split!r}")
        # MOVi levels are letters (D, E), STEVE-MOVi's words (Solid, Tex)
        self.level = level.upper() if layout == "movi" else \
            level.capitalize()
        self.layout = layout
        self.split = split
        self.data_root = osp.join(data_root, f"MOVi-{self.level}", split)
        self.transforms = BaseTransforms(resolution, load_truncated=True)
        self.n_sample_frames = n_sample_frames
        self.frame_offset = frame_offset or 1
        self.video_len = video_len
        self.load_mask = load_mask
        self.load_video = False  # whole videos (test_seg, extract_slots)
        self.valid_idx = self._index_clips()

    def _index_clips(self):
        tag = hashlib.md5(osp.abspath(self.data_root).encode()).hexdigest()
        cache = osp.join(cache_dir(), "splits", "MOVi",
                         f"{self.level}-{self.layout}-{tag[:8]}",
                         f"{self.split}.json")
        if osp.isfile(cache):
            self.files = load_obj(cache)
        else:
            self.files = glob_all(osp.join(self.data_root, "*"),
                                  only_dir=True)
            if not self.files:
                raise FileNotFoundError(
                    f"no MOVi videos under {self.data_root}")
            dump_obj(self.files, cache)
        valid = []
        span = (self.n_sample_frames - 1) * self.frame_offset
        if self.split == "train":
            for folder in self.files:
                valid += [(folder, s) for s in range(self.video_len - span)]
        elif self.split == "test":
            valid = [(folder, 0) for folder in self.files]
        else:
            size = self.n_sample_frames * self.frame_offset
            for folder in self.files:
                for idx in range(0, self.video_len - size + 1, size):
                    valid += [(folder, idx + i)
                              for i in range(self.frame_offset)]
        return valid

    def _frame_path(self, folder, i):
        if self.layout == "movi":
            return osp.join(folder, f"{i:06d}.jpg")
        return osp.join(folder, f"{i:08d}_image.png")

    def _read_mask(self, folder, i):
        """One frame's id mask at the dataset's resolution: a grayscale PNG
        through the JAX native path's nearest resize; RGB-coded ids
        (flattened to ints), palette masks and masks whose data ends early
        at PIL's NEAREST; in the STEVE-MOVi layout the argmax of the 10
        binary masks behind an all-ones background."""
        if self.layout == "steve_movi":
            objs = [imageio.read_image(
                osp.join(folder, f"{i:08d}_mask_{k:02d}.png"),
                truncated_ok=True).convert("L").array
                for k in range(self.NUM_STEVE_MASKS)]
            objs.insert(0, np.ones_like(objs[0]))
            return self.transforms.process_mask(
                np.stack(objs).argmax(0).astype(np.int32))
        path = osp.join(folder, f"{i:06d}_mask.png")
        m = self.transforms.load_mask(path)
        if m is not None:
            return m
        m = imageio.read_image(path, truncated_ok=True).array
        if m.ndim == 3:
            H, W = m.shape[:2]
            flat = (m[..., 0].astype(np.int64) * 256 + m[..., 1]) * 256 + \
                m[..., 2]
            m = np.unique(flat, return_inverse=True)[1].reshape(H, W)
        return self.transforms.process_mask(m)

    def _read_clip(self, folder, start, num):
        frames, masks = [], []
        for n in range(num):
            i = start + n * self.frame_offset
            try:
                frames.append(self.transforms.load_image(
                    self._frame_path(folder, i)))
                if self.load_mask:
                    masks.append(self._read_mask(folder, i))
            except (FileNotFoundError, OSError) as e:
                raise SampleError(str(e))
        img = np.stack(frames).astype(np.float32)
        return img, (suppress_mask_idx(np.stack(masks))
                     if self.load_mask else None)

    def get_video(self, video_idx):
        img, mask = self._read_clip(self.files[video_idx], 0,
                                    self.video_len // self.frame_offset)
        out = {"img": img, "data_idx": np.int32(video_idx)}
        if mask is not None:
            out["masks"] = mask
        return out

    def __len__(self):
        return len(self.files) if self.load_video else len(self.valid_idx)

    def __getitem__(self, idx):
        if self.load_video:
            return self.get_video(idx)
        folder, start = self.valid_idx[idx]
        img, mask = self._read_clip(folder, start, self.n_sample_frames)
        out = {"data_idx": np.int32(idx), "img": img}
        if mask is not None:
            out["masks"] = mask
        return out


def build_movi_dataset(params, val_only=False):
    """-> the test split (`val_only`), or (train, validation); the train
    split loads no masks. `params.dataset` "steve_movi" picks the
    STEVE-MOVi layout."""
    kw = dict(level=params.movi_level, data_root=params.data_root,
              layout="steve_movi" if params.dataset == "steve_movi"
              else "movi",
              resolution=params.resolution,
              n_sample_frames=params.n_sample_frames,
              frame_offset=getattr(params, "frame_offset", 1),
              video_len=getattr(params, "video_len", 24),
              load_mask=params.load_mask)
    if val_only:
        return MOViDataset(split="test", **kw)
    val = MOViDataset(split="validation", **kw)
    kw["load_mask"] = False
    return MOViDataset(split="train", **kw), val
