"""LPIPS perceptual distance on a VGG16 backbone (an own copy of the JAX
package's ops/lpips.py, the VQ-VAE's perceptual loss): inputs in [-1, 1]
shifted and scaled by LPIPS's ImageNet constants -> the 13 VGG16 3x3
convs with ReLU and 2x2 max pools -> the ReLU outputs after the last
conv of each of the 5 blocks -> each unit-normalized over its channels
(eps outside the sqrt, as the `lpips` package) -> squared difference
weighted by a per-channel linear head, summed over channels, averaged
over positions -> summed over the 5 taps. Plain `F.conv2d`: the JAX
package has no kernel here.

Weights come from an `.npz` in the JAX package's layout (`conv{i}_w`
OIHW or HWIO, `conv{i}_b`, `lin{j}_w`), named by an explicit path or by
`SLOTDIFFUSION_LPIPS_WEIGHTS`. The real VGG16/LPIPS weights are not in
the repository: `convert_torch_lpips_npz` writes the `.npz` from a local
torchvision VGG16 and `lpips` state dict, and `save_random_lpips_npz`
writes the JAX function's seeded stand-in bit for bit. The net is frozen:
its weights are buffers, so a gradient reaches the inputs and never the
weights. A metric prints under `weights_label` (`ops/_provenance.py`).
"""

import functools
import os

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ._provenance import file_sha256
from ._provenance import weights_label as _weights_label

# VGG16 features: conv channels per block, "M" a 2x2 max pool; the ReLU
# outputs of these conv indices (0-based) are the taps
_VGG_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
            512, 512, 512, "M", 512, 512, 512]
_TAPS = (1, 3, 6, 9, 12)
_IMAGENET_MEAN = np.array([-0.030, -0.088, -0.188], np.float32)
_IMAGENET_STD = np.array([0.458, 0.448, 0.450], np.float32)

WEIGHTS_ENV = "SLOTDIFFUSION_LPIPS_WEIGHTS"


def weights_path(path=None):
    """`path`, else the file `SLOTDIFFUSION_LPIPS_WEIGHTS` names ("" for
    none)."""
    return path or os.environ.get(WEIGHTS_ENV, "")


def lpips_available(path=None):
    return os.path.isfile(weights_path(path))


def weights_label(name, path=None):
    """The metric's name with its weights' provenance (`ops/_provenance`):
    `lpips(untrained-weights)` for a seeded stand-in; the pin is the sha
    of the published torchvision VGG16 state dict (vgg16-397923af.pth)."""
    return _weights_label(name, weights_path(path),
                          pinned_sha_prefix="397923af")


class LPIPS(nn.Module):
    """The VGG16 + linear heads of one `.npz`; forward(x, y) on NHWC
    images in [-1, 1] -> [B] distances, in f32."""

    def __init__(self, arrays):
        super().__init__()
        for i in range(sum(c != "M" for c in _VGG_CFG)):
            w = np.asarray(arrays[f"conv{i}_w"], np.float32)
            if not (w.shape[2] == 3 and w.shape[3] == 3):  # HWIO -> OIHW
                w = w.transpose(3, 2, 0, 1)
            self.register_buffer(f"conv{i}_w", torch.from_numpy(w.copy()))
            self.register_buffer(f"conv{i}_b", torch.from_numpy(
                np.asarray(arrays[f"conv{i}_b"], np.float32).copy()))
        for j in range(len(_TAPS)):
            self.register_buffer(f"lin{j}_w", torch.from_numpy(
                np.asarray(arrays[f"lin{j}_w"], np.float32).reshape(-1)))
        self.register_buffer("mean", torch.from_numpy(_IMAGENET_MEAN))
        self.register_buffer("std", torch.from_numpy(_IMAGENET_STD))

    def features(self, x):
        """NHWC -> the 5 tap activations, NCHW."""
        h = ((x.float() - self.mean) / self.std).permute(0, 3, 1, 2)
        feats, ci = [], 0
        for spec in _VGG_CFG:
            if spec == "M":
                h = F.max_pool2d(h, 2, 2)
                continue
            h = F.relu(F.conv2d(h, getattr(self, f"conv{ci}_w"),
                                getattr(self, f"conv{ci}_b"), padding=1))
            if ci in _TAPS:
                feats.append(h)
            ci += 1
        return feats

    def forward(self, x, y):
        total = 0.0
        unit = lambda f: f / (torch.sqrt(torch.sum(f ** 2, 1, keepdim=True))
                              + 1e-10)
        for j, (f1, f2) in enumerate(zip(self.features(x),
                                         self.features(y))):
            diff = (unit(f1) - unit(f2)) ** 2
            lw = getattr(self, f"lin{j}_w")
            total = total + torch.mean(
                torch.sum(diff * lw[None, :, None, None], 1), dim=(1, 2))
        return total


@functools.lru_cache(maxsize=4)
def _net(path, mtime, device):
    with np.load(path) as data:
        return LPIPS({k: data[k] for k in data.files}).to(device)


def load_lpips(path=None, device="cuda"):
    """The frozen net of the `.npz` at `path` (default: the environment's),
    on `device` (the card unless the caller asks for the CPU, as every
    entry point of the port); cached per file (and its modification time)
    and device."""
    p = weights_path(path)
    if not os.path.isfile(p):
        raise FileNotFoundError(
            f"no LPIPS weights at {p!r}: pass a path or set {WEIGHTS_ENV}")
    return _net(os.path.abspath(p), os.path.getmtime(p),
                str(torch.device(device)))


def lpips_distance(x, y, path=None):
    """LPIPS(VGG) between NHWC images in [-1, 1] -> [B] distances."""
    return load_lpips(path, x.device)(x, y)


def save_random_lpips_npz(out_path, seed=0):
    """Write a seeded random VGG16 + LPIPS npz in the loader's layout: the
    JAX package's `save_random_lpips_npz`, array for array (numpy's
    RandomState, the same draws in the same order). He-scaled convs keep
    the distances O(1), so the perceptual term trains stably before real
    weights exist."""
    rng = np.random.RandomState(seed)
    out = {}
    in_ch = 3
    ci = 0
    for spec in _VGG_CFG:
        if spec == "M":
            continue
        fan_in = in_ch * 9
        out[f"conv{ci}_w"] = rng.normal(
            0, np.sqrt(2.0 / fan_in), (spec, in_ch, 3, 3)).astype(np.float32)
        out[f"conv{ci}_b"] = np.zeros((spec,), np.float32)
        in_ch = spec
        ci += 1
    for j, tap in enumerate(_TAPS):
        ch = [c for c in _VGG_CFG if c != "M"][tap]
        out[f"lin{j}_w"] = rng.uniform(0, 2.0 / ch, (ch,)).astype(np.float32)
    np.savez(out_path, **out)
    return out_path


def convert_torch_lpips_npz(vgg_state_path, lpips_state_path, out_path):
    """A torchvision VGG16 state dict and the `lpips` package's linear
    heads (`lin{j}.model.1.weight`) -> the loader's `.npz` (OIHW convs),
    with the VGG file's sha256 (`__source_sha256__`). The `features.N`
    keys are taken in numeric order: a lexicographic sort would put
    `features.10` before `features.2` and scramble the convs. The JAX
    package's converter writes the same arrays."""
    vgg = torch.load(vgg_state_path, map_location="cpu")
    lp = torch.load(lpips_state_path, map_location="cpu")
    conv_keys = sorted((k for k in vgg if k.startswith("features")
                        and k.endswith(".weight")),
                       key=lambda k: int(k.split(".")[1]))
    out = {}
    for i, k in enumerate(conv_keys):
        out[f"conv{i}_w"] = vgg[k].numpy()
        out[f"conv{i}_b"] = vgg[k.replace("weight", "bias")].numpy()
    for j in range(len(_TAPS)):
        out[f"lin{j}_w"] = lp[f"lin{j}.model.1.weight"].numpy()
    out["__source_sha256__"] = file_sha256(vgg_state_path)
    np.savez(out_path, **out)
    return out_path
