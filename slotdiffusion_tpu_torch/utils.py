"""Host-side helpers of the port (own copies of the JAX package's
utils/misc.py:17-75): the running mean of a metric, pickle/JSON files,
sorted globs, the datasets' cache directory."""

import glob
import json
import math
import os
import pickle


_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def cache_dir():
    """Where the datasets cache their file lists: `SLOTDIFFUSION_CACHE`,
    by default `.cache/slotdiffusion_tpu_torch/` in the repo."""
    return os.environ.get("SLOTDIFFUSION_CACHE", os.path.join(
        _REPO, ".cache", "slotdiffusion_tpu_torch"))


class AverageMeter:
    """The running mean of a scalar, weighted by `n`; NaN values are
    skipped (the upstream metrics average with np.nanmean)."""

    def __init__(self):
        self.sum = 0.0
        self.count = 0

    def update(self, val, n=1):
        val = float(val)
        if math.isnan(val):
            return
        self.sum += val * n
        self.count += n

    @property
    def avg(self):
        return self.sum / self.count if self.count > 0 else 0.0


def mkdir_or_exist(path):
    os.makedirs(path, exist_ok=True)
    return path


def load_obj(path):
    """Read a JSON (`.json`) or pickle (any other name) file."""
    if path.endswith(".json"):
        with open(path) as f:
            return json.load(f)
    with open(path, "rb") as f:
        return pickle.load(f)


def dump_obj(obj, path):
    """Write `obj` as JSON (`.json`) or pickle, making the directory."""
    mkdir_or_exist(os.path.dirname(os.path.abspath(path)))
    if path.endswith(".json"):
        with open(path, "w") as f:
            json.dump(obj, f)
        return
    with open(path, "wb") as f:
        pickle.dump(obj, f)


def glob_all(pattern, only_dir=False):
    """Sorted glob, directories only with `only_dir`."""
    files = sorted(glob.glob(pattern))
    return [f for f in files if os.path.isdir(f)] if only_dir else files
