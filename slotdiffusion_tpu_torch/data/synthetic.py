"""Synthetic video clips for training without data on disk (an own numpy
copy of the JAX package's data/synthetic.py:145-189
`SyntheticVideoDataset`): squares of random colours drifting with constant
velocity over a dark background, `img` in [-1, 1] as [T, H, W, 3] and
the object ids as `masks` [T, H, W], every clip a function of
(seed, index).

`SyntheticVideoData` batches them with a `torch.utils.data.DataLoader`
in the order of the JAX package's loader (data/loader.py:158-166): a
permutation seeded by `seed + epoch`, whole batches only. A trainer that
resumes mid-epoch asks for the batches from `start`.
"""

import numpy as np
from torch.utils.data import DataLoader, Dataset


class SyntheticVideoDataset(Dataset):
    max_objects = 4

    def __init__(self, resolution=(64, 64), num_samples=64,
                 n_sample_frames=3, seed=0):
        self.resolution = tuple(resolution)
        self.num_samples = num_samples
        self.n_frames = n_sample_frames
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
        return {
            "img": (np.stack(frames) * 2.0 - 1.0).astype(np.float32),
            "data_idx": np.int32(idx),
            "masks": np.stack(masks),
        }


class SyntheticVideoData:
    """The train split of synthetic clips at a config's resolution and
    clip length, in batches of `batch_size`."""

    def __init__(self, params, batch_size, num_samples=256, seed=0):
        self.dataset = SyntheticVideoDataset(
            resolution=tuple(params.resolution), num_samples=num_samples,
            n_sample_frames=params.n_sample_frames, seed=seed)
        self.batch_size = batch_size
        self.seed = seed
        if len(self) == 0:
            raise ValueError(f"{num_samples} clips make no batch of "
                             f"{batch_size}")

    def __len__(self):
        """Batches per epoch."""
        return len(self.dataset) // self.batch_size

    def train_loader(self, epoch, start=0):
        """Batches `start..` of `epoch`, as dicts of CPU tensors."""
        order = np.random.RandomState(self.seed + epoch).permutation(
            len(self.dataset))
        batches = [order[b * self.batch_size:(b + 1) * self.batch_size]
                   .tolist() for b in range(start, len(self))]
        return DataLoader(self.dataset, batch_sampler=batches)
