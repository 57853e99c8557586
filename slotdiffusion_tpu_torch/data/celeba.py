"""CelebA, images only (an own copy of the JAX package's
data/celeba.py:19-67): `img_align_celeba/` with `list_eval_partition.txt`,
whose split ids 0/1/2 are train/val/test; no masks. Each sample is
{"img": [H, W, 3] in [-1, 1], "data_idx"}. The JPEGs decode and resize
as the JAX dataset's do through PIL (`data/imageio.py`: libjpeg-turbo's
decode, PIL's BILINEAR), bit for bit. A file that cannot be read, or
whose data ends early, raises `SampleError`.
"""

import os.path as osp

import numpy as np
from torch.utils.data import Dataset

from .loader import SampleError
from .transforms import BaseTransforms

_SPLIT_ID = {"train": "0", "val": "1", "test": "2"}


class CelebADataset(Dataset):

    def __init__(self, data_root, resolution, split="train"):
        self.transforms = BaseTransforms(resolution)
        part_file = osp.join(data_root, "list_eval_partition.txt")
        img_dir = osp.join(data_root, "img_align_celeba")
        if not osp.isfile(part_file):
            raise FileNotFoundError(part_file)
        want = _SPLIT_ID[split]
        self.files = []
        with open(part_file) as f:
            for line in f:
                parts = line.split()
                if len(parts) == 2 and parts[1] == want:
                    self.files.append(osp.join(img_dir, parts[0]))

    def __len__(self):
        return len(self.files)

    def __getitem__(self, idx):
        try:
            img = self.transforms(
                self.transforms.read_rgb(self.files[idx]))
        except (FileNotFoundError, OSError) as e:
            raise SampleError(str(e))
        return {"data_idx": np.int32(idx), "img": img.astype(np.float32)}


def build_celeba_dataset(params, val_only=False):
    """-> the val split (`val_only`), or (train, val)."""
    kw = dict(data_root=params.data_root, resolution=params.resolution)
    val = CelebADataset(split="val", **kw)
    if val_only:
        return val
    return CelebADataset(split="train", **kw), val
