"""The Physion video dataset (an own copy of the JAX package's
data/physion.py): frame folders `{data_root}/{video}/{frame:06d}.jpg`
listed by split JSONs ({task: [video .mp4 names]}) of a subset
(`training`, `readout` or `test`), looked up under
`{data_root}/splits/`, `{data_root}/splits/Physion/`, then the port's
cache directory (`utils.cache_dir()`, `splits/Physion/`).

Clips of `n_sample_frames` frames `frame_offset` apart: the train split
at every start that fits, the val and test splits strided by
`n_sample_frames * frame_offset`, each stride start followed by the next
`frame_offset - 1` (the frame-offset interleave). `load_video` switches
to whole videos (`get_video`: every `frame_offset`-th frame). Each video
keeps its task's index in `all_tasks` (`video_idx2task_idx`), for the
VQA per-task breakdown. The JPEGs decode as the JAX reader's do
(`data/fastio.py`), and one whose data ends early decodes as libjpeg
decodes it, as the JAX module's `ImageFile.LOAD_TRUNCATED_IMAGES` lets it.
"""

import os.path as osp

import numpy as np
from torch.utils.data import Dataset

from ..utils import cache_dir, load_obj
from .loader import SampleError
from .transforms import BaseTransforms

ALL_TASKS = ["Collide", "Contain", "Dominoes", "Drape", "Drop", "Link",
             "Roll", "Support"]


def find_split_file(data_root, subset, split):
    """The path of `{subset}_{split}.json`; FileNotFoundError if no
    candidate has it."""
    cands = [
        osp.join(data_root, "splits", f"{subset}_{split}.json"),
        osp.join(data_root, "splits", "Physion", f"{subset}_{split}.json"),
        osp.join(cache_dir(), "splits", "Physion",
                 f"{subset}_{split}.json"),
    ]
    for c in cands:
        if osp.isfile(c):
            return c
    raise FileNotFoundError(
        f"Physion split file {subset}_{split}.json not found in {cands}")


class PhysionDataset(Dataset):

    def __init__(self, data_root, resolution, split="train", tasks=("all",),
                 n_sample_frames=6, frame_offset=1, video_len=150,
                 subset="training"):
        if subset in ("training", "readout"):
            assert split in ("train", "val")
        elif subset == "test":
            assert split == "test"
        else:
            raise ValueError(f"unknown subset {subset}")
        self.data_root = data_root
        self.split = split
        self.subset = subset
        self.transforms = BaseTransforms(resolution, load_truncated=True)
        self.n_sample_frames = n_sample_frames
        self.frame_offset = frame_offset or 1
        self.video_len = video_len
        self.load_video = False

        json_file = load_obj(find_split_file(data_root, subset, split))
        self.all_tasks = sorted(json_file.keys())
        self.task2num = {t: len(json_file[t]) for t in self.all_tasks}
        tasks = list(tasks)
        if tasks[0].lower() == "all":
            tasks = list(json_file.keys())
        self.tasks = tasks
        self.files = []
        self.video_idx2task_idx = {}
        for task in tasks:
            first = len(self.files)
            self.files += [osp.join(data_root, f[:-4])  # strip ".mp4"
                           for f in json_file[task]]
            for i in range(first, len(self.files)):
                self.video_idx2task_idx[i] = self.all_tasks.index(task)
        self.num_videos = len(self.files)
        self.valid_idx = self._index_clips()

    def _index_clips(self):
        valid = []
        span = (self.n_sample_frames - 1) * self.frame_offset
        if self.split == "train":
            for folder in self.files:
                valid += [(folder, s) for s in range(self.video_len - span)]
        else:
            size = self.n_sample_frames * self.frame_offset
            for folder in self.files:
                starts = []
                for idx in range(0, self.video_len - size + 1, size):
                    starts += [idx + i for i in range(self.frame_offset)]
                valid += [(folder, s) for s in starts]
        return valid

    def _read_clip(self, folder, start, num):
        frames = []
        for n in range(num):
            path = osp.join(folder,
                            f"{start + n * self.frame_offset:06d}.jpg")
            try:
                frames.append(self.transforms.load_image(path))
            except (FileNotFoundError, OSError) as e:
                raise SampleError(str(e))
        return np.stack(frames).astype(np.float32)

    def get_video(self, video_idx):
        img = self._read_clip(self.files[video_idx], 0,
                              self.video_len // self.frame_offset)
        return {"video": img, "img": img, "data_idx": np.int32(video_idx)}

    def __len__(self):
        return len(self.files) if self.load_video else len(self.valid_idx)

    def __getitem__(self, idx):
        if self.load_video:
            return self.get_video(idx)
        folder, start = self.valid_idx[idx]
        return {"data_idx": np.int32(idx),
                "img": self._read_clip(folder, start, self.n_sample_frames)}


def build_physion_dataset(params, val_only=False):
    """The subset is the dataset name's last word (`physion_training`,
    `physion_readout`, `physion_test`), else `params.subset`. -> the test
    set, the val set (`val_only`) or (train, val)."""
    subset = params.dataset.split("_")[-1]
    if subset not in ("training", "readout", "test"):
        subset = getattr(params, "subset", "training")
    kw = dict(data_root=params.data_root, resolution=params.resolution,
              tasks=list(getattr(params, "tasks", ["all"])),
              n_sample_frames=params.n_sample_frames,
              frame_offset=getattr(params, "frame_offset", 1),
              video_len=getattr(params, "video_len", 150), subset=subset)
    if subset == "test":
        return PhysionDataset(split="test", **kw)
    val = PhysionDataset(split="val", **kw)
    if val_only:
        return val
    return PhysionDataset(split="train", **kw), val
