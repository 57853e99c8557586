"""MOVi video datasets (an own copy of the JAX package's data/movi.py:
33-205, the MOVi layout): frame-folder videos
`{data_root}/MOVi-{L}/{split}/{video}/{frame:06d}.jpg` with grayscale id
masks `{frame:06d}_mask.png`.

Clips per split: train, every valid start index; validation, strided
non-overlapping clips; test, one clip a video. Each sample is
{"img": [T, H, W, 3] in [-1, 1], "masks": [T, H, W] int32 ids made
consecutive (with `load_mask`), "data_idx"}; `load_video` switches to
whole videos. A split's folder list is cached (as JSON) under
`SLOTDIFFUSION_CACHE`, by default `.cache/slotdiffusion_tpu_torch/` in the
repo. A frame that cannot be read raises `SampleError`, so the loader
tries another clip. The STEVE-MOVi layout is not ported yet.
"""

import hashlib
import os
import os.path as osp

import numpy as np
from torch.utils.data import Dataset

from ..utils import dump_obj, glob_all, load_obj
from .loader import SampleError
from .transforms import BaseTransforms, suppress_mask_idx

_REPO = osp.dirname(osp.dirname(osp.dirname(osp.abspath(__file__))))


def _cache_dir():
    return os.environ.get("SLOTDIFFUSION_CACHE", osp.join(
        _REPO, ".cache", "slotdiffusion_tpu_torch"))


class MOViDataset(Dataset):
    def __init__(self, level, data_root, resolution, split="train",
                 n_sample_frames=6, frame_offset=1, video_len=24,
                 load_mask=False):
        if split == "val":
            split = "validation"
        if split not in ("train", "validation", "test"):
            raise ValueError(f"unknown MOVi split {split!r}")
        self.level = level.upper()
        self.split = split
        self.data_root = osp.join(data_root, f"MOVi-{self.level}", split)
        self.transforms = BaseTransforms(resolution)
        self.n_sample_frames = n_sample_frames
        self.frame_offset = frame_offset or 1
        self.video_len = video_len
        self.load_mask = load_mask
        self.load_video = False  # whole videos (test_seg, extract_slots)
        self.valid_idx = self._index_clips()

    def _index_clips(self):
        tag = hashlib.md5(osp.abspath(self.data_root).encode()).hexdigest()
        cache = osp.join(_cache_dir(), "splits", "MOVi",
                         f"{self.level}-movi-{tag[:8]}", f"{self.split}.json")
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

    def _read_mask(self, path):
        """One frame's id mask at the dataset's resolution: grayscale PNGs
        natively, RGB-coded ids (flattened to ints) through PIL."""
        m = self.transforms.load_mask(path)
        if m is not None:
            return m
        from PIL import Image
        m = np.asarray(Image.open(path))
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
                    osp.join(folder, f"{i:06d}.jpg")))
                if self.load_mask:
                    masks.append(self._read_mask(
                        osp.join(folder, f"{i:06d}_mask.png")))
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
    split loads no masks."""
    kw = dict(level=params.movi_level, data_root=params.data_root,
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
