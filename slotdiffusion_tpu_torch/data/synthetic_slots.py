"""Slot datasets of the video-prediction stage without data on disk (an
own copy of the JAX package's data/synthetic_slots.py and of its
`build_dataset`, data/builders.py:59-127); every sample equals the JAX
dataset's bit for bit.

- `SyntheticSlotsDataset`: smooth per-slot trajectories (sinusoids of
  random frequency, phase and amplitude, numpy `RandomState(seed * 99991
  + idx)`), optionally with a label the trajectory determines and a
  `task_idx`.
- `SyntheticVideoSlotsDataset`: slots from an extraction pickle
  (`scripts/extract_slots_torch.py`, {name: [T, N, C]}), paired with the
  synthetic videos they came from, re-rendered from the same (seed,
  index) when `load_img`; `data_idx` is the source video's index.
- `SyntheticRolloutSlotsDataset`: rolled-out slots
  (`scripts/rollout_physion_slots_torch.py`) with a VQA label of the
  source video, "does it hold at least ceil((max_objects + 1) / 2)
  objects", re-derived from the renderer's own draw; the object count is
  the per-task breakdown.
"""

import numpy as np
from torch.utils.data import Dataset

from ..utils import load_obj
from .synthetic import SyntheticVideoDataset


class SyntheticSlotsDataset(Dataset):
    """{"slots": [T, N, C], "data_idx", with `with_labels` "label" and
    "task_idx"}."""

    def __init__(self, num_samples=256, num_slots=6, slot_size=64,
                 video_len=16, with_labels=False, seed=0):
        self.num_samples = num_samples
        self.num_slots = num_slots
        self.slot_size = slot_size
        self.video_len = video_len
        self.with_labels = with_labels
        self.seed = seed

    def __len__(self):
        return self.num_samples

    def __getitem__(self, idx):
        rng = np.random.RandomState(self.seed * 99991 + idx)
        T, N, C = self.video_len, self.num_slots, self.slot_size
        t = np.arange(T)[:, None, None]
        freq = rng.rand(1, N, C) * 0.3
        phase = rng.rand(1, N, C) * 2 * np.pi
        amp = rng.rand(1, N, C)
        slots = amp * np.sin(freq * t + phase)
        out = {"data_idx": np.int32(idx), "slots": slots.astype(np.float32)}
        if self.with_labels:
            out["label"] = np.int32(float(slots.mean()) > 0.0)
            out["task_idx"] = np.int32(idx % 8)
        return out


class SyntheticRolloutSlotsDataset(Dataset):
    """{"slots", "data_idx", "label", "task_idx"} of one split of a
    rollout pickle ({name: [T, N, C]}, the names the source videos'
    indices)."""

    def __init__(self, rollout_slots, seed=0, max_objects=4):
        self.rollout_slots = rollout_slots
        self.names = sorted(rollout_slots.keys(), key=lambda s: int(s))
        self.seed = seed
        self.max_objects = max_objects
        self.label_min_objects = (max_objects + 2) // 2
        self.all_tasks = [f"objects_{i + 1}" for i in range(max_objects)]

    def __len__(self):
        return len(self.names)

    def _n_objects(self, video_idx):
        # the renderer's first draw (data/synthetic.py SyntheticVideoDataset)
        rng = np.random.RandomState(self.seed * 100003 + video_idx)
        return int(rng.randint(1, self.max_objects + 1))

    def __getitem__(self, idx):
        name = self.names[idx]
        n_obj = self._n_objects(int(name))
        return {"slots": np.asarray(self.rollout_slots[name], np.float32),
                "data_idx": np.int32(idx),
                "label": np.int32(n_obj >= self.label_min_objects),
                "task_idx": np.int32(n_obj - 1)}


class SyntheticVideoSlotsDataset(Dataset):
    """{"slots", "data_idx" (the source video's index), with `load_img`
    "img" [T, H, W, 3]} of one split of an extraction pickle."""

    def __init__(self, video_slots, resolution=(64, 64), video_len=8,
                 max_objects=4, load_img=False, seed=0):
        self.video_slots = video_slots
        self.names = sorted(video_slots.keys(), key=lambda s: int(s))
        self.load_img = load_img
        self._video = SyntheticVideoDataset(
            resolution=tuple(resolution), num_samples=len(self.names),
            n_sample_frames=video_len, max_objects=max_objects,
            load_mask=False, seed=seed)

    def __len__(self):
        return len(self.names)

    def __getitem__(self, idx):
        name = self.names[idx]
        out = {"slots": np.asarray(self.video_slots[name], np.float32),
               "data_idx": np.int32(int(name))}
        if self.load_img:
            out["img"] = self._video[int(name)]["img"]
        return out


def build_slots_dataset(params, val_only=False):
    """The datasets of `params.dataset` "synthetic_slots",
    "synthetic_video_slots" or "synthetic_rollout_slots", with the sizes,
    seeds (train 0, val and test 1) and checks of the JAX
    `build_dataset`. -> the val (or test) set with `val_only`, else
    (train, val)."""
    name = params.dataset
    get = lambda k, d: getattr(params, k, d)
    if name == "synthetic_slots":
        cfg = next(c for c in (get("slot_dict", None),
                               get("rollout_dict", None),
                               get("readout_dict", None)) if c)
        kw = dict(num_slots=cfg["num_slots"], slot_size=cfg["slot_size"],
                  video_len=get("video_len", 16),
                  with_labels=get("with_labels", False))
        val = SyntheticSlotsDataset(num_samples=get("val_samples", 32),
                                    seed=1, **kw)
        if val_only:
            return val
        return SyntheticSlotsDataset(num_samples=get("train_samples", 256),
                                     seed=0, **kw), val
    if name == "synthetic_video_slots":
        all_slots = load_obj(params.slots_root)
        kw = dict(resolution=tuple(params.resolution),
                  video_len=get("video_len", 8),
                  max_objects=get("max_objects", 4),
                  load_img=get("load_img", False))
        val_split = all_slots.get("val", all_slots.get("test"))
        if val_split is None:
            raise ValueError(
                f"synthetic_video_slots: the slots pickle "
                f"{params.slots_root!r} has neither a 'val' nor a 'test' "
                f"split (it has {sorted(all_slots)}); "
                "extract_slots_torch.py writes both")
        val = SyntheticVideoSlotsDataset(val_split, seed=1, **kw)
        if val_only:
            return val
        return SyntheticVideoSlotsDataset(all_slots["train"], seed=0,
                                          **kw), val
    if name == "synthetic_rollout_slots":
        all_slots = load_obj(params.rollout_root)
        meta = all_slots.pop("_meta", None)
        max_objects = get("max_objects", 4)
        if meta is not None and meta.get("max_objects", -1) != -1 and \
                meta["max_objects"] != max_objects:
            raise ValueError(
                f"the rollout pickle {params.rollout_root!r} comes from "
                f"videos rendered with max_objects={meta['max_objects']} "
                f"(config {meta.get('params')}), this config sets "
                f"max_objects={max_objects}: the VQA labels would not be "
                "the rendered scenes'")
        test = all_slots.get("test", all_slots.get("val"))
        if test is None:
            raise ValueError(
                f"synthetic_rollout_slots: the rollout pickle "
                f"{params.rollout_root!r} has neither a 'test' nor a 'val' "
                f"split (it has {sorted(all_slots)})")
        kw = dict(max_objects=max_objects)
        if val_only:
            return SyntheticRolloutSlotsDataset(test, seed=1, **kw)
        return (SyntheticRolloutSlotsDataset(all_slots["train"], seed=0,
                                             **kw),
                SyntheticRolloutSlotsDataset(all_slots.get("val", test),
                                             seed=1, **kw))
    raise ValueError(f"not a synthetic slots dataset: {name!r}")
