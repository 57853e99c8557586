"""Physion slot datasets of the video-prediction stage (an own copy of the
JAX package's data/physion_slots.py):

- `PhysionSlotsDataset`: clips of a video's slots from an extraction
  pickle ({split: {video name: [T, N, C]}}), indexed as the video
  dataset's clips, the frames `frame_offset` apart; with `load_img` the
  clip's frames too.
- `PhysionSlotsLabelDataset`: one (whole-video slots, VQA label) pair a
  video, its `task_idx`; the labels from the subset's CSV (`readout`:
  `PhysionTrainMP4s/readout_labels.csv`, keys without the folders'
  `_img`; `test`: `PhysionTestMP4s/labels.csv`, keys without
  `-redyellow`), read with the standard library (a leading index column
  and a "ground truth outcome" column); on `test` the stimuli that
  `splits/bad_stimuli.txt` lists are dropped.
"""

import csv
import os.path as osp

import numpy as np

from ..utils import load_obj
from .loader import SampleError
from .physion import PhysionDataset


def load_label_csv(path):
    """{stimulus name: 0 or 1} of a Physion label CSV."""
    labels = {}
    with open(path, newline="") as f:
        reader = csv.reader(f)
        header = next(reader)
        gt_col = header.index("ground truth outcome")
        for row in reader:
            labels[row[0]] = 1 if row[gt_col].strip().lower() in (
                "true", "1", "yes") else 0
    return labels


def _read_lines(path):
    with open(path) as f:
        return [line.rstrip("\n") for line in f]


class PhysionSlotsDataset(PhysionDataset):
    """{"slots": [n_sample_frames, N, C], "data_idx", with `load_img`
    "img"}."""

    def __init__(self, data_root, video_slots, resolution, split="train",
                 tasks=("all",), n_sample_frames=25, frame_offset=1,
                 video_len=150, subset="training", load_img=False):
        super().__init__(
            data_root=data_root, resolution=resolution, split=split,
            tasks=tasks, n_sample_frames=n_sample_frames,
            frame_offset=frame_offset, video_len=video_len, subset=subset)
        self.video_slots = video_slots
        self.load_img = load_img

    def _read_slots(self, folder, start, num):
        name = osp.basename(folder)
        if name not in self.video_slots:
            raise SampleError(f"no slots for video {name}")
        slots = self.video_slots[name]
        try:
            picked = [slots[start + n * self.frame_offset]
                      for n in range(num)]
        except IndexError as e:
            raise SampleError(str(e))
        return np.stack(picked).astype(np.float32)

    def __getitem__(self, idx):
        folder, start = self.valid_idx[idx]
        out = {"data_idx": np.int32(idx),
               "slots": self._read_slots(folder, start,
                                         self.n_sample_frames)}
        if self.load_img:
            out["img"] = self._read_clip(folder, start, self.n_sample_frames)
        return out


class PhysionSlotsLabelDataset(PhysionSlotsDataset):
    """{"slots": [video_len, N, C], "label", "task_idx", "data_idx", with
    `load_img` "img"}, one a video."""

    def __init__(self, data_root, video_slots, resolution, split="train",
                 tasks=("all",), n_sample_frames=15, frame_offset=1,
                 video_len=150, subset="readout", load_img=False):
        assert frame_offset in (None, 1)
        if subset == "readout":
            label_fn = osp.join(data_root, "PhysionTrainMP4s",
                                "readout_labels.csv")
        elif subset == "test":
            label_fn = osp.join(data_root, "PhysionTestMP4s", "labels.csv")
        else:
            raise ValueError(subset)
        self.labels = load_label_csv(label_fn)
        super().__init__(
            data_root=data_root, video_slots=video_slots,
            resolution=resolution, split=split, tasks=tasks,
            n_sample_frames=n_sample_frames, frame_offset=1,
            video_len=video_len, subset=subset, load_img=load_img)
        self.sample_idx = list(range(video_len))
        if subset == "test":
            bad_path = osp.join(data_root, "splits", "bad_stimuli.txt")
            if osp.isfile(bad_path):
                bad = _read_lines(bad_path)
                self.files = [f for f in self.files if not any(
                    s in f.replace("-redyellow", "") for s in bad)]

    def _read_label(self, file_idx):
        key = osp.basename(self.files[file_idx])
        if key.endswith(".mp4"):
            key = key[:-4]
        if self.subset == "readout" and key.endswith("_img"):
            key = key[:-4]
        if self.subset == "test" and "-redyellow" in key:
            key = key.replace("-redyellow", "")
        if key not in self.labels:
            raise SampleError(f"no label for {key}")
        return np.int32(self.labels[key])

    def __len__(self):
        return len(self.files)

    def __getitem__(self, idx):
        folder = self.files[idx]
        name = osp.basename(folder)
        if name not in self.video_slots:
            raise SampleError(f"no slots for video {name}")
        slots = self.video_slots[name]
        try:
            picked = np.stack([slots[i] for i in self.sample_idx])
        except IndexError as e:
            raise SampleError(str(e))
        out = {"data_idx": np.int32(idx),
               "task_idx": np.int32(self.video_idx2task_idx[idx]),
               "slots": picked.astype(np.float32),
               "label": self._read_label(idx)}
        if self.load_img:
            out["img"] = self._read_clip(folder, 0, len(self.sample_idx))
        return out


def build_physion_slots_dataset(params, val_only=False):
    """The datasets of a `physion_slots*` name: with "label" or "readout"
    in it the label datasets, else the clip ones; the subset is the
    name's last word (`training`, `readout`, `test`), else
    `params.subset`, else `readout` for a label name and `training`
    otherwise. Each split takes its entry of the pickle
    (`params.slots_root`), or the whole pickle where it has none."""
    video_slots = load_obj(params.slots_root)
    name = params.dataset
    label = "label" in name or "readout" in name
    tail = name.split("_")[-1]
    subset = tail if tail in ("training", "readout", "test") else getattr(
        params, "subset", "readout" if label else "training")
    common = dict(data_root=params.data_root, resolution=params.resolution,
                  tasks=list(getattr(params, "tasks", ["all"])),
                  n_sample_frames=params.n_sample_frames,
                  frame_offset=getattr(params, "frame_offset", 1),
                  video_len=getattr(params, "video_len", 150),
                  load_img=getattr(params, "load_img", False))
    cls = PhysionSlotsLabelDataset if label else PhysionSlotsDataset
    if subset == "test":
        return cls(video_slots=video_slots.get("test", video_slots),
                   split="test", subset="test", **common)
    val = cls(video_slots=video_slots.get("val", video_slots), split="val",
              subset=subset, **common)
    if val_only:
        return val
    return cls(video_slots=video_slots.get("train", video_slots),
               split="train", subset=subset, **common), val
