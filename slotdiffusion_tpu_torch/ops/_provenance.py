"""Weight provenance of the metric networks (FID's InceptionV3, FVD's I3D,
LPIPS's VGG16): an own copy of the JAX package's ops/_provenance.py.

A converter writes `__source_sha256__` (the sha256 of the torch state
dict it read) into its `.npz`, so a printed metric names the weights it
came from. A file without it (a seeded stand-in) never prints as the
bare metric: it is labelled `{name}(untrained-weights)`.
"""

import hashlib

import numpy as np


def file_sha256(path):
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def weights_label(name, weights_path, pinned_sha_prefix=None):
    """The metric's name with the provenance of the `.npz` at
    `weights_path`:

    - no `__source_sha256__` (or no readable file) ->
      `{name}(untrained-weights)`;
    - a source sha that does not start with `pinned_sha_prefix` ->
      `{name}[UNVERIFIED src=<sha8>]`;
    - a matching one (or no pin, `pinned_sha_prefix=None`) ->
      `{name}[src=<sha8>]`.
    """
    sha = ""
    try:
        with np.load(weights_path) as data:
            if "__source_sha256__" in data.files:
                sha = str(data["__source_sha256__"])
    except Exception:
        pass
    if not sha:
        return f"{name}(untrained-weights)"
    if pinned_sha_prefix is not None and not sha.startswith(
            pinned_sha_prefix):
        return f"{name}[UNVERIFIED src={sha[:8]}]"
    return f"{name}[src={sha[:8]}]"
