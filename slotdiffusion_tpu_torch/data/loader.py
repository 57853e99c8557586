"""Batching of the input pipeline on `torch.utils.data` (the counterpart
of the JAX package's data/loader.py:40-90, 111-166, 335-372).

- `SampleError`: a dataset raises it for a sample it cannot decode; the
  loader then loads another index, drawn from a generator seeded by
  (seed, index), up to `max_retries` times.
- An epoch's order: `arange` or, shuffled, the permutation seeded by
  `seed + epoch`; whole batches only with `drop_last`. A trainer that
  resumes mid-epoch asks for the batches from `start`.
- `DataModule`: the train loader of an epoch and the val loader (not
  shuffled, the last batch ragged), each through the dataset's
  `collate_fn` where it needs one (COCO's); a train set with `set_epoch`
  is told the epoch first (its augmentation draws by it). Worker
  processes (`num_workers`) are spawned, not forked (the parent may hold
  threads: CUDA's, a JAX runtime's), and seed numpy from torch's
  per-worker seed, torch's from the epoch.
"""

import numpy as np
import torch
from torch.utils.data import DataLoader, Dataset


class SampleError(Exception):
    """Raised by a dataset for a corrupted or undecodable sample."""


def fetch_with_retry(dataset, idx, seed, max_retries=3):
    """dataset[idx], or on SampleError another index, as the JAX loader
    draws it."""
    rng = np.random.RandomState((seed + 1) * 7919 + int(idx))
    for _ in range(max_retries + 1):
        try:
            return dataset[int(idx)]
        except SampleError:
            idx = rng.randint(0, len(dataset))
    raise RuntimeError(
        f"failed to load a valid sample after {max_retries} retries")


class _Retrying(Dataset):
    def __init__(self, dataset, seed):
        self.dataset, self.seed = dataset, seed

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, idx):
        return fetch_with_retry(self.dataset, idx, self.seed)


def epoch_batches(n, batch_size, shuffle=False, drop_last=True, seed=0,
                  epoch=0):
    """The index batches of one epoch over `n` samples."""
    order = np.random.RandomState(seed + epoch).permutation(n) \
        if shuffle else np.arange(n)
    count = n // batch_size if drop_last else -(-n // batch_size)
    return [order[b * batch_size:(b + 1) * batch_size].tolist()
            for b in range(count)]


def _seed_worker(worker_id):
    np.random.seed(torch.initial_seed() % 2 ** 32)


def make_loader(dataset, batches, seed=0, num_workers=0, collate_fn=None):
    """A DataLoader yielding `batches` (lists of indices) of `dataset` as
    dicts of CPU tensors (batched by `collate_fn`, else torch's
    default)."""
    return DataLoader(
        _Retrying(dataset, seed), batch_sampler=batches,
        num_workers=num_workers, worker_init_fn=_seed_worker,
        collate_fn=collate_fn,
        generator=torch.Generator().manual_seed(seed),
        multiprocessing_context="spawn" if num_workers > 0 else None)


class DataModule:
    """The train and val loaders of a run. `len()` is the train batches
    of an epoch."""

    def __init__(self, train_set, val_set, batch_size, val_batch_size=None,
                 seed=0, num_workers=0, collate_fn=None):
        self.train_set, self.val_set = train_set, val_set
        self.collate_fn = collate_fn
        self.batch_size = batch_size
        self.val_batch_size = val_batch_size or batch_size
        self.seed = seed
        self.num_workers = num_workers
        if train_set is not None and len(self) == 0:
            raise ValueError(f"{len(train_set)} samples make no batch of "
                             f"{batch_size}")

    def __len__(self):
        return len(self.train_set) // self.batch_size

    def train_loader(self, epoch, start=0):
        """Batches `start..` of `epoch`, shuffled, whole batches only."""
        batches = epoch_batches(len(self.train_set), self.batch_size, True,
                                True, self.seed, epoch)[start:]
        if hasattr(self.train_set, "set_epoch"):
            self.train_set.set_epoch(epoch)
        return make_loader(self.train_set, batches, self.seed + epoch,
                           self.num_workers, self.collate_fn)

    def val_loader(self):
        """The val set in order, the last batch ragged; None without
        one."""
        if self.val_set is None:
            return None
        batches = epoch_batches(len(self.val_set), self.val_batch_size,
                                False, False)
        return make_loader(self.val_set, batches, self.seed,
                           self.num_workers, self.collate_fn)
