"""FVD (Frechet Video Distance) features of the port: an own copy of the
JAX package's ops/fvd.py in PyTorch.

The Kinetics-400 InceptionI3d (Inception-V1 inflated to 3D, Carreira &
Zisserman 2017) with every Unit3D's BatchNorm (eps 1e-3) folded into its
conv by `convert_torch_i3d_npz` (the pytorch-i3d layout: `<Block>.conv3d.
weight`, `<Block>.bn.*`, branches `b0/b1a/b1b/b2a/b2b/b3b`, the final
`logits` with a bias and no BN). The protocol is the standard FVD one:
clips resized to 224x224 (bilinear, half-pixel, no antialias) and mapped
to [-1, 1]; the features are the 400 pre-softmax logits averaged over
time; the distance is FID's Frechet distance (`ops/fid.py`).

Every conv and max pool pads as TF's "SAME" does (the JAX package's
`jax.lax` "SAME"): per axis a total of max((ceil(n / s) - 1) * s + k - n,
0), its smaller half in front, so the extra value goes at the end where
the total is odd; pools pad with -inf. `F.conv3d` / `F.max_pool3d` after
an explicit `F.pad` (the JAX package computes it outside any Pallas
kernel). The weights come from an `.npz` named by an explicit path or by
`SLOTDIFFUSION_I3D_WEIGHTS`; the real ones are not in the repository
(`save_random_i3d_npz` writes a seeded stand-in without a source sha,
whose metrics print as `fvd(untrained-weights)`).
"""

import functools
import math
import os

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ._provenance import file_sha256
from ._provenance import weights_label as _weights_label
from .fid import (FeatureStats, _fold_bn, _load_state,  # noqa: F401
                  frechet_distance, randomise_bn_, resize_bilinear)

WEIGHTS_ENV = "SLOTDIFFUSION_I3D_WEIGHTS"
_BN_EPS = 1e-3  # pytorch-i3d's BatchNorm3d eps
SIDE = 224
DIM = 400
MIN_FRAMES = 9  # the shortest clip the network's pools leave a time axis

# Inception-V1 blocks: input channels and the outputs of [b0, b1a, b1b,
# b2a, b2b, b3b]
_MIXED = {
    "Mixed_3b": (192, [64, 96, 128, 16, 32, 32]),
    "Mixed_3c": (256, [128, 128, 192, 32, 96, 64]),
    "Mixed_4b": (480, [192, 96, 208, 16, 48, 64]),
    "Mixed_4c": (512, [160, 112, 224, 24, 64, 64]),
    "Mixed_4d": (512, [128, 128, 256, 24, 64, 64]),
    "Mixed_4e": (512, [112, 144, 288, 32, 64, 64]),
    "Mixed_4f": (528, [256, 160, 320, 32, 128, 128]),
    "Mixed_5b": (832, [256, 160, 320, 32, 128, 128]),
    "Mixed_5c": (832, [384, 192, 384, 48, 128, 128]),
}


def _convs():
    """path -> (input channels, output channels, kernel, stride)."""
    one, three = (1, 1, 1), (3, 3, 3)
    out = {"Conv3d_1a_7x7": (3, 64, (7, 7, 7), (2, 2, 2)),
           "Conv3d_2b_1x1": (64, 64, one, one),
           "Conv3d_2c_3x3": (64, 192, three, one)}
    for name, (cin, ch) in _MIXED.items():
        out[f"{name}.b0"] = (cin, ch[0], one, one)
        out[f"{name}.b1a"] = (cin, ch[1], one, one)
        out[f"{name}.b1b"] = (ch[1], ch[2], three, one)
        out[f"{name}.b2a"] = (cin, ch[3], one, one)
        out[f"{name}.b2b"] = (ch[3], ch[4], three, one)
        out[f"{name}.b3b"] = (cin, ch[5], one, one)
    out["logits"] = (1024, DIM, one, one)
    return out


_CONVS = _convs()


def weights_path(path=None):
    """`path`, else the file `SLOTDIFFUSION_I3D_WEIGHTS` names ("" for
    none)."""
    return path or os.environ.get(WEIGHTS_ENV, "")


def i3d_available(path=None):
    return os.path.isfile(weights_path(path))


def weights_label(name, path=None):
    """The metric's name with its weights' provenance (`ops/_provenance`);
    no pin: the I3D file FVD uses publishes no hash."""
    return _weights_label(name, weights_path(path), pinned_sha_prefix=None)


def same_pads(shape, kernel, stride):
    """F.pad's argument for TF "SAME" over the trailing len(kernel) axes
    of `shape`: (front, back) per axis, last axis first."""
    pads = []
    for n, k, s in zip(shape[-len(kernel):], kernel, stride):
        total = max((math.ceil(n / s) - 1) * s + k - n, 0)
        pads.append((total // 2, total - total // 2))
    return [v for p in reversed(pads) for v in p]


class I3D(nn.Module):
    """The folded network of one `.npz` (DHWIO weights and biases, the
    converter's layout); forward(x) on NCTHW clips of 224x224 in [-1, 1]
    -> [B, 400]. The weights are buffers: the net is frozen."""

    def __init__(self, arrays):
        super().__init__()
        for path in _CONVS:
            w = np.asarray(arrays[f"{path}_w"], np.float32)  # DHWIO
            self.register_buffer(self._name(path, "w"), torch.from_numpy(
                np.ascontiguousarray(w.transpose(4, 3, 0, 1, 2))))
            self.register_buffer(self._name(path, "b"), torch.from_numpy(
                np.asarray(arrays[f"{path}_b"], np.float32).copy()))

    @staticmethod
    def _name(path, what):
        return f"{path.replace('.', '__')}_{what}"

    def conv(self, h, path, relu=True):
        _, _, kernel, stride = _CONVS[path]
        h = F.conv3d(F.pad(h, same_pads(h.shape, kernel, stride)),
                     getattr(self, self._name(path, "w")),
                     getattr(self, self._name(path, "b")), stride=stride)
        return F.relu(h) if relu else h

    @staticmethod
    def max_pool(h, kernel, stride):
        h = F.pad(h, same_pads(h.shape, kernel, stride), value=-math.inf)
        return F.max_pool3d(h, kernel, stride)

    def mixed(self, h, p):
        return torch.cat([
            self.conv(h, f"{p}.b0"),
            self.conv(self.conv(h, f"{p}.b1a"), f"{p}.b1b"),
            self.conv(self.conv(h, f"{p}.b2a"), f"{p}.b2b"),
            self.conv(self.max_pool(h, (3, 3, 3), (1, 1, 1)), f"{p}.b3b")],
            1)

    def forward(self, x):
        h = self.conv(x, "Conv3d_1a_7x7")
        h = self.max_pool(h, (1, 3, 3), (1, 2, 2))
        h = self.conv(self.conv(h, "Conv3d_2b_1x1"), "Conv3d_2c_3x3")
        h = self.max_pool(h, (1, 3, 3), (1, 2, 2))
        h = self.mixed(self.mixed(h, "Mixed_3b"), "Mixed_3c")
        h = self.max_pool(h, (3, 3, 3), (2, 2, 2))
        for p in ("Mixed_4b", "Mixed_4c", "Mixed_4d", "Mixed_4e",
                  "Mixed_4f"):
            h = self.mixed(h, p)
        h = self.max_pool(h, (2, 2, 2), (2, 2, 2))
        h = self.mixed(self.mixed(h, "Mixed_5b"), "Mixed_5c")
        # a VALID (2, 7, 7) average, stride 1 (pytorch-i3d's forward)
        h = F.avg_pool3d(h, (2, 7, 7), stride=1)
        h = self.conv(h, "logits", relu=False)
        return h.mean(dim=(2, 3, 4))


@functools.lru_cache(maxsize=4)
def _net(path, mtime, device):
    with np.load(path) as data:
        return I3D({k: data[k] for k in data.files}).to(device)


def load_i3d(path=None, device="cuda"):
    """The frozen network of the `.npz` at `path` (default: the
    environment's) on `device`, cached per file (and its modification
    time) and device."""
    p = weights_path(path)
    if not os.path.isfile(p):
        raise FileNotFoundError(
            f"no I3D weights at {p!r}: pass a path or set {WEIGHTS_ENV}")
    return _net(os.path.abspath(p), os.path.getmtime(p),
                str(torch.device(device)))


@torch.no_grad()
def i3d_features(videos, path=None):
    """FVD features [B, 400] (f32) of clips [B, T, H, W, 3] in [0, 1],
    T >= 9, on the clips' device."""
    x = torch.as_tensor(videos).float()
    B, T = x.shape[:2]
    if T < MIN_FRAMES:
        raise ValueError(f"I3D needs >= {MIN_FRAMES} frames, got {T}")
    x = resize_bilinear(x.reshape(B * T, *x.shape[2:]), SIDE)
    x = x.reshape(B, T, SIDE, SIDE, -1).permute(0, 4, 1, 2, 3)
    net = load_i3d(path, x.device)
    return net(x.contiguous() * 2.0 - 1.0)


def fvd_from_features(feats1, feats2):
    """The Frechet distance between two feature arrays [N, 400]."""
    s1, s2 = FeatureStats(feats1.shape[1]), FeatureStats(feats2.shape[1])
    s1.update(feats1)
    s2.update(feats2)
    return frechet_distance(*s1.finalize(), *s2.finalize())


def fold_i3d(sd):
    """{path_w: DHWIO f32, path_b: f32} of a pytorch-i3d-layout state
    dict: each Unit3D's conv and BatchNorm folded in float64, `logits`'
    plain bias kept."""
    out = {}
    for path in _CONVS:
        key = f"{path}.conv3d.weight"
        if f"{path}.bn.weight" in sd:
            w, b = _fold_bn(sd, path, key, _BN_EPS)
        else:  # logits: a plain bias, no BN
            w = sd[key].numpy().astype(np.float64)
            b = sd[f"{path}.conv3d.bias"].numpy().astype(np.float64)
        out[f"{path}_w"] = w.transpose(2, 3, 4, 1, 0).astype(np.float32)
        out[f"{path}_b"] = b.astype(np.float32)
    return out


def convert_torch_i3d_npz(state_path, out_path):
    """Fold a pytorch-i3d-layout `InceptionI3d` state dict into the `.npz`
    the network reads, with the source's sha256 (`__source_sha256__`).
    The JAX package's converter writes the same arrays."""
    out = fold_i3d(_load_state(state_path))
    out["__source_sha256__"] = file_sha256(state_path)
    np.savez(out_path, **out)
    return out_path


def random_i3d_state_dict(seed=0):
    """A seeded pytorch-i3d-layout state dict: He-scaled conv weights, so
    the features stay O(1), randomised BatchNorms, `logits` with a bias
    N(0, 0.1): a stand-in for the real weights, whose FVD measures
    nothing."""
    g = torch.Generator().manual_seed(seed)
    sd = {}
    for path, (cin, cout, kernel, _) in _CONVS.items():
        fan_in = cin * math.prod(kernel)
        sd[f"{path}.conv3d.weight"] = torch.randn(
            cout, cin, *kernel, generator=g) * (2.0 / fan_in) ** 0.5
        if path == "logits":
            sd[f"{path}.conv3d.bias"] = torch.randn(cout, generator=g) * 0.1
        else:
            randomise_bn_(sd, path, cout, g)
    return sd


def save_random_i3d_npz(out_path, seed=0):
    """The folded `random_i3d_state_dict(seed)` as an `.npz` with no
    source sha: its metrics print as `fvd(untrained-weights)`."""
    np.savez(out_path, **fold_i3d(random_i3d_state_dict(seed)))
    return out_path
