"""Image and mask transforms of the input pipeline (an own copy of the
JAX package's data/transforms.py:13-74): images to float32 [-1, 1],
resized bilinearly; id masks resized nearest-neighbour; NHWC numpy.

Files decode through `data/imageio.py` and `data/fastio.py`, with the
decoder picked by the file's format as the JAX package's readers pick
theirs: a JPEG frame under the (0.5, 0.5) normalisation takes the JAX
native path's fused decode and float resize, any other image PIL's
arithmetic (decode, `convert("RGB")`, BILINEAR); a grayscale mask PNG
the native nearest resize, another mask PIL's NEAREST.
"""

import numpy as np

from . import fastio, imageio


def suppress_mask_idx(mask):
    """Relabel the ids of a mask to consecutive 0..K."""
    ids = np.unique(mask)
    lut = np.zeros(int(ids.max()) + 1, dtype=mask.dtype)
    for new, old in enumerate(ids):
        lut[old] = new
    return lut[mask]


def _is_jpeg(path):
    return path.lower().endswith((".jpg", ".jpeg"))


class BaseTransforms:
    """img: uint8 [H, W, 3] -> float32 [-1, 1] at `resolution` (H, W).
    `load_truncated`: accept files whose data ends early, as PIL does
    under `ImageFile.LOAD_TRUNCATED_IMAGES` (the JAX MOVi and Physion
    modules set it)."""

    def __init__(self, resolution, norm_mean=0.5, norm_std=0.5,
                 load_truncated=False):
        self.resolution = tuple(resolution)
        self.norm_mean = norm_mean
        self.norm_std = norm_std
        self.load_truncated = load_truncated

    def __call__(self, img):
        arr = imageio.resize_bilinear(np.asarray(img, np.uint8),
                                      self.resolution)
        arr = np.asarray(arr, np.float32) / 255.0
        return (arr - self.norm_mean) / self.norm_std

    def read_rgb(self, path):
        """An image file -> uint8 [H, W, 3], `Image.open(path).convert
        ("RGB")`."""
        return imageio.read_image(path, self.load_truncated).convert(
            "RGB").array

    def load_image(self, path):
        """Read, resize and normalize one image file. A JPEG under the
        (0.5, 0.5) normalisation takes the JAX native path's fused decode
        and resize (a CMYK JPEG, which that path cannot decode, the other
        way); any other file decodes, converts to RGB and resizes as PIL
        does. OSError or FileNotFoundError as `Image.open` raises them."""
        if (self.norm_mean, self.norm_std) == (0.5, 0.5) and \
                _is_jpeg(path):
            with open(path, "rb") as f:
                data = f.read()
            if imageio.jpeg_info(data, path)[3] not in (3, 4):
                return fastio.decode_jpeg_norm(path, self.resolution, data)
        return self(self.read_rgb(path))

    def process_mask(self, mask):
        """int mask [H, W] -> int32 [H, W] at `resolution`, nearest."""
        return imageio.resize_nearest(np.asarray(mask).astype(np.int32),
                                      self.resolution)

    def load_mask(self, path):
        """A grayscale id-mask PNG -> int32 [H, W] through the JAX native
        path's nearest resize; None for another file, which the caller
        reads and resizes with `process_mask`."""
        if path.lower().endswith(".png"):
            out = fastio.decode_png_mask(path, self.resolution)
            if out is not None:
                return out.astype(np.int32)
        return None
