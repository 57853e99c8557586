"""Mask visualisation of the port: an own copy of the JAX package's
utils/vis.py (the upstream `vis.py` palette and alpha-blended overlays),
numpy on the host."""

import numpy as np

# the 20-colour palette, RGB in [0, 255]
PALETTE = np.array([
    (230, 25, 75), (60, 180, 75), (255, 225, 25), (0, 130, 200),
    (245, 130, 48), (145, 30, 180), (70, 240, 240), (240, 50, 230),
    (210, 245, 60), (250, 190, 212), (0, 128, 128), (220, 190, 255),
    (170, 110, 40), (255, 250, 200), (128, 0, 0), (170, 255, 195),
    (128, 128, 0), (255, 215, 180), (0, 0, 128), (128, 128, 128),
], dtype=np.uint8)


def _to_uint8(img):
    """uint8 as it is; floats in [-1, 1] (any value below -0.01) or
    [0, 1] -> uint8 by clip(x, 0, 1) * 255, truncated."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        if img.min() < -0.01:
            img = (img + 1.0) / 2.0
        img = (np.clip(img, 0.0, 1.0) * 255).astype(np.uint8)
    return img


def draw_mask(img, mask, alpha=0.4, palette=None):
    """img [H, W, 3] (float in [-1, 1] or [0, 1], or uint8) overlaid with
    the palette colour of each id of the integer mask [H, W] -> uint8."""
    img = _to_uint8(img).astype(np.float32)
    mask = np.asarray(mask).astype(np.int64)
    pal = PALETTE if palette is None else np.asarray(palette)
    colors = pal[mask % len(pal)].astype(np.float32)
    out = (1.0 - alpha) * img + alpha * colors
    return np.clip(out, 0, 255).astype(np.uint8)


def draw_rgb_mask(img, mask, alpha=0.4):
    """img overlaid with an already coloured mask [H, W, 3] -> uint8."""
    img = _to_uint8(img).astype(np.float32)
    rgb = _to_uint8(mask).astype(np.float32)
    out = (1.0 - alpha) * img + alpha * rgb
    return np.clip(out, 0, 255).astype(np.uint8)


def make_grid(imgs, ncol=8, pad=2, pad_value=255):
    """[N, H, W, C] images tiled into one grid, `ncol` a row, `pad` pixels
    of `pad_value` between them."""
    imgs = np.asarray(imgs)
    N, H, W, C = imgs.shape
    ncol = min(ncol, N)
    nrow = -(-N // ncol)
    grid = np.full((nrow * (H + pad) - pad, ncol * (W + pad) - pad, C),
                   pad_value, dtype=imgs.dtype)
    for i in range(N):
        r, c = divmod(i, ncol)
        grid[r * (H + pad):r * (H + pad) + H,
             c * (W + pad):c * (W + pad) + W] = imgs[i]
    return grid
