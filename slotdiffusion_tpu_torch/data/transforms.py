"""Image and mask transforms of the input pipeline (an own copy of the
JAX package's data/transforms.py:13-74): images to float32 [-1, 1],
resized bilinearly; id masks resized nearest-neighbour; NHWC numpy.

PIL is imported only where a file or an array is decoded or resized by
it: JPEG frames and grayscale PNG masks take the native path
(`data/fastio.py`) where it builds.
"""

import numpy as np


def suppress_mask_idx(mask):
    """Relabel the ids of a mask to consecutive 0..K."""
    ids = np.unique(mask)
    lut = np.zeros(int(ids.max()) + 1, dtype=mask.dtype)
    for new, old in enumerate(ids):
        lut[old] = new
    return lut[mask]


class BaseTransforms:
    """img: PIL image or uint8 [H, W, 3] -> float32 [-1, 1] at
    `resolution` (H, W)."""

    def __init__(self, resolution, norm_mean=0.5, norm_std=0.5):
        self.resolution = tuple(resolution)
        self.norm_mean = norm_mean
        self.norm_std = norm_std

    def __call__(self, img):
        from PIL import Image
        if isinstance(img, np.ndarray):
            img = Image.fromarray(img)
        img = img.resize(self.resolution[::-1], Image.BILINEAR)
        arr = np.asarray(img, np.float32) / 255.0
        return (arr - self.norm_mean) / self.norm_std

    def load_image(self, path):
        """Read, resize and normalize one image file: a JPEG with the
        (0.5, 0.5) normalization through the native decode, anything else
        (or a failed native decode) through PIL. Raises OSError or
        FileNotFoundError as `Image.open` does."""
        if (self.norm_mean, self.norm_std) == (0.5, 0.5) and \
                path.lower().endswith((".jpg", ".jpeg")):
            from .fastio import decode_jpeg_norm
            out = decode_jpeg_norm(path, self.resolution)
            if out is not None:
                return out
        from PIL import Image
        return self(Image.open(path).convert("RGB"))

    def process_mask(self, mask):
        """int mask [H, W] -> int32 [H, W] at `resolution`, nearest."""
        from PIL import Image
        m = Image.fromarray(np.asarray(mask).astype(np.int32), mode="I")
        m = m.resize(self.resolution[::-1], Image.NEAREST)
        return np.asarray(m, np.int32)

    def load_mask(self, path):
        """A grayscale id-mask PNG -> int32 [H, W] through the native
        decode; None for other files (the caller decodes with PIL)."""
        if path.lower().endswith(".png"):
            from .fastio import decode_png_mask
            out = decode_png_mask(path, self.resolution)
            if out is not None:
                return out.astype(np.int32)
        return None
