"""FID (Frechet Inception Distance) of the port: an own copy of the JAX
package's ops/fid.py in PyTorch.

The protocol is `pytorch-fid`'s:
- images in [0, 1] are resized to 299x299 (bilinear, half-pixel centres,
  no antialias: `F.interpolate(align_corners=False, antialias=False)`, the
  counterpart of the JAX package's `jax.image.resize(..., antialias=
  False)`) and mapped to [-1, 1];
- the network is torchvision's InceptionV3 with the FID patches: every
  3x3 average-pool branch leaves the padding out of its divisor
  (`count_include_pad=False`) and Mixed_7c's pool branch takes the max;
- the features are the 2048 pool3 activations;
- FID = |mu1 - mu2|^2 + tr(S1 + S2 - 2 sqrt(S1 S2)), the covariances over
  samples (ddof 1), retried with eps * I where sqrt(S1 S2) is not finite.

Each BasicConv2d (conv + BatchNorm, eps 1e-3) is folded into one conv
with a bias by `convert_torch_inception_npz`; the network runs them as
`F.conv2d` + bias + ReLU (the JAX package computes it outside any Pallas
kernel). The weights come from an `.npz` named by an explicit path or by
`SLOTDIFFUSION_INCEPTION_WEIGHTS`; the real ones are not in the
repository: `random_inception_state_dict` makes a seeded stand-in in
their layout, and `save_random_inception_npz` writes it folded without a
source sha, so its metrics print as `fid(untrained-weights)`.
"""

import functools
import os

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ._provenance import file_sha256
from ._provenance import weights_label as _weights_label

WEIGHTS_ENV = "SLOTDIFFUSION_INCEPTION_WEIGHTS"
_BN_EPS = 1e-3  # torchvision Inception3's BatchNorm eps
SIDE = 299
DIM = 2048


def weights_path(path=None):
    """`path`, else the file `SLOTDIFFUSION_INCEPTION_WEIGHTS` names ("" for
    none)."""
    return path or os.environ.get(WEIGHTS_ENV, "")


def inception_available(path=None):
    return os.path.isfile(weights_path(path))


def weights_label(name, path=None):
    """The metric's name with its weights' provenance (`ops/_provenance`);
    the pin is the 8-hex tag of the published pt_inception file."""
    return _weights_label(name, weights_path(path),
                          pinned_sha_prefix="6726825d")


# ---------------------------------------------------------------------------
# Every BasicConv2d of torchvision's Inception3 by its state-dict path:
# (path, input channels, output channels, kernel (kh, kw), stride,
# padding (ph, pw)). The converter, the network and the seeded stand-in
# all read this one table.
# ---------------------------------------------------------------------------

def _a(p, cin, pool_features):  # InceptionA (Mixed_5b/5c/5d)
    return [(f"{p}.branch1x1", cin, 64, (1, 1), 1, (0, 0)),
            (f"{p}.branch5x5_1", cin, 48, (1, 1), 1, (0, 0)),
            (f"{p}.branch5x5_2", 48, 64, (5, 5), 1, (2, 2)),
            (f"{p}.branch3x3dbl_1", cin, 64, (1, 1), 1, (0, 0)),
            (f"{p}.branch3x3dbl_2", 64, 96, (3, 3), 1, (1, 1)),
            (f"{p}.branch3x3dbl_3", 96, 96, (3, 3), 1, (1, 1)),
            (f"{p}.branch_pool", cin, pool_features, (1, 1), 1, (0, 0))]


def _b(p, cin):  # InceptionB (Mixed_6a)
    return [(f"{p}.branch3x3", cin, 384, (3, 3), 2, (0, 0)),
            (f"{p}.branch3x3dbl_1", cin, 64, (1, 1), 1, (0, 0)),
            (f"{p}.branch3x3dbl_2", 64, 96, (3, 3), 1, (1, 1)),
            (f"{p}.branch3x3dbl_3", 96, 96, (3, 3), 2, (0, 0))]


def _c(p, c7):  # InceptionC (Mixed_6b..6e), 768 channels in
    return [(f"{p}.branch1x1", 768, 192, (1, 1), 1, (0, 0)),
            (f"{p}.branch7x7_1", 768, c7, (1, 1), 1, (0, 0)),
            (f"{p}.branch7x7_2", c7, c7, (1, 7), 1, (0, 3)),
            (f"{p}.branch7x7_3", c7, 192, (7, 1), 1, (3, 0)),
            (f"{p}.branch7x7dbl_1", 768, c7, (1, 1), 1, (0, 0)),
            (f"{p}.branch7x7dbl_2", c7, c7, (7, 1), 1, (3, 0)),
            (f"{p}.branch7x7dbl_3", c7, c7, (1, 7), 1, (0, 3)),
            (f"{p}.branch7x7dbl_4", c7, c7, (7, 1), 1, (3, 0)),
            (f"{p}.branch7x7dbl_5", c7, 192, (1, 7), 1, (0, 3)),
            (f"{p}.branch_pool", 768, 192, (1, 1), 1, (0, 0))]


def _d(p):  # InceptionD (Mixed_7a), 768 channels in
    return [(f"{p}.branch3x3_1", 768, 192, (1, 1), 1, (0, 0)),
            (f"{p}.branch3x3_2", 192, 320, (3, 3), 2, (0, 0)),
            (f"{p}.branch7x7x3_1", 768, 192, (1, 1), 1, (0, 0)),
            (f"{p}.branch7x7x3_2", 192, 192, (1, 7), 1, (0, 3)),
            (f"{p}.branch7x7x3_3", 192, 192, (7, 1), 1, (3, 0)),
            (f"{p}.branch7x7x3_4", 192, 192, (3, 3), 2, (0, 0))]


def _e(p, cin):  # InceptionE (Mixed_7b/7c)
    return [(f"{p}.branch1x1", cin, 320, (1, 1), 1, (0, 0)),
            (f"{p}.branch3x3_1", cin, 384, (1, 1), 1, (0, 0)),
            (f"{p}.branch3x3_2a", 384, 384, (1, 3), 1, (0, 1)),
            (f"{p}.branch3x3_2b", 384, 384, (3, 1), 1, (1, 0)),
            (f"{p}.branch3x3dbl_1", cin, 448, (1, 1), 1, (0, 0)),
            (f"{p}.branch3x3dbl_2", 448, 384, (3, 3), 1, (1, 1)),
            (f"{p}.branch3x3dbl_3a", 384, 384, (1, 3), 1, (0, 1)),
            (f"{p}.branch3x3dbl_3b", 384, 384, (3, 1), 1, (1, 0)),
            (f"{p}.branch_pool", cin, 192, (1, 1), 1, (0, 0))]


_ALL_CONVS = (
    [("Conv2d_1a_3x3", 3, 32, (3, 3), 2, (0, 0)),
     ("Conv2d_2a_3x3", 32, 32, (3, 3), 1, (0, 0)),
     ("Conv2d_2b_3x3", 32, 64, (3, 3), 1, (1, 1)),
     ("Conv2d_3b_1x1", 64, 80, (1, 1), 1, (0, 0)),
     ("Conv2d_4a_3x3", 80, 192, (3, 3), 1, (0, 0))]
    + _a("Mixed_5b", 192, 32) + _a("Mixed_5c", 256, 64)
    + _a("Mixed_5d", 288, 64) + _b("Mixed_6a", 288)
    + _c("Mixed_6b", 128) + _c("Mixed_6c", 160) + _c("Mixed_6d", 160)
    + _c("Mixed_6e", 192) + _d("Mixed_7a")
    + _e("Mixed_7b", 1280) + _e("Mixed_7c", 2048))

_CONV_SPEC = {path: (s, p) for path, _, _, _, s, p in _ALL_CONVS}


class InceptionV3(nn.Module):
    """The folded pool3 network of one `.npz` (HWIO weights and biases,
    the converter's layout); forward(x) on NCHW images of 299x299 in
    [-1, 1] -> [B, 2048]. The weights are buffers: the net is frozen."""

    def __init__(self, arrays):
        super().__init__()
        for path in _CONV_SPEC:
            w = np.asarray(arrays[f"{path}_w"], np.float32)  # HWIO
            self.register_buffer(self._name(path, "w"), torch.from_numpy(
                np.ascontiguousarray(w.transpose(3, 2, 0, 1))))
            self.register_buffer(self._name(path, "b"), torch.from_numpy(
                np.asarray(arrays[f"{path}_b"], np.float32).copy()))

    @staticmethod
    def _name(path, what):
        return f"{path.replace('.', '__')}_{what}"

    def conv(self, h, path):
        stride, pad = _CONV_SPEC[path]
        return F.relu(F.conv2d(h, getattr(self, self._name(path, "w")),
                               getattr(self, self._name(path, "b")),
                               stride=stride, padding=pad))

    def chain(self, h, prefix, names):
        for n in names:
            h = self.conv(h, f"{prefix}.{n}")
        return h

    @staticmethod
    def avg_pool(h):
        """3x3 stride-1 pad-1, the padding out of the divisor (the
        pytorch-fid patch of every A, C and E pool branch)."""
        return F.avg_pool2d(h, 3, 1, 1, count_include_pad=False)

    def block_a(self, h, p):
        return torch.cat([
            self.conv(h, f"{p}.branch1x1"),
            self.chain(h, p, ("branch5x5_1", "branch5x5_2")),
            self.chain(h, p, ("branch3x3dbl_1", "branch3x3dbl_2",
                              "branch3x3dbl_3")),
            self.conv(self.avg_pool(h), f"{p}.branch_pool")], 1)

    def block_b(self, h, p):
        return torch.cat([
            self.conv(h, f"{p}.branch3x3"),
            self.chain(h, p, ("branch3x3dbl_1", "branch3x3dbl_2",
                              "branch3x3dbl_3")),
            F.max_pool2d(h, 3, 2)], 1)

    def block_c(self, h, p):
        return torch.cat([
            self.conv(h, f"{p}.branch1x1"),
            self.chain(h, p, [f"branch7x7_{i}" for i in (1, 2, 3)]),
            self.chain(h, p, [f"branch7x7dbl_{i}" for i in range(1, 6)]),
            self.conv(self.avg_pool(h), f"{p}.branch_pool")], 1)

    def block_d(self, h, p):
        return torch.cat([
            self.chain(h, p, ("branch3x3_1", "branch3x3_2")),
            self.chain(h, p, [f"branch7x7x3_{i}" for i in (1, 2, 3, 4)]),
            F.max_pool2d(h, 3, 2)], 1)

    def block_e(self, h, p, max_pool=False):
        b3 = self.conv(h, f"{p}.branch3x3_1")
        bd = self.chain(h, p, ("branch3x3dbl_1", "branch3x3dbl_2"))
        # Mixed_7c's pool branch takes the max (pytorch-fid's patch)
        bp = F.max_pool2d(h, 3, 1, 1) if max_pool else self.avg_pool(h)
        return torch.cat([
            self.conv(h, f"{p}.branch1x1"),
            self.conv(b3, f"{p}.branch3x3_2a"),
            self.conv(b3, f"{p}.branch3x3_2b"),
            self.conv(bd, f"{p}.branch3x3dbl_3a"),
            self.conv(bd, f"{p}.branch3x3dbl_3b"),
            self.conv(bp, f"{p}.branch_pool")], 1)

    def forward(self, x):
        h = x
        for n in ("Conv2d_1a_3x3", "Conv2d_2a_3x3", "Conv2d_2b_3x3"):
            h = self.conv(h, n)
        h = F.max_pool2d(h, 3, 2)
        h = self.conv(self.conv(h, "Conv2d_3b_1x1"), "Conv2d_4a_3x3")
        h = F.max_pool2d(h, 3, 2)
        for p in ("Mixed_5b", "Mixed_5c", "Mixed_5d"):
            h = self.block_a(h, p)
        h = self.block_b(h, "Mixed_6a")
        for p in ("Mixed_6b", "Mixed_6c", "Mixed_6d", "Mixed_6e"):
            h = self.block_c(h, p)
        h = self.block_d(h, "Mixed_7a")
        h = self.block_e(h, "Mixed_7b")
        h = self.block_e(h, "Mixed_7c", max_pool=True)
        return h.mean(dim=(2, 3))


@functools.lru_cache(maxsize=4)
def _net(path, mtime, device):
    with np.load(path) as data:
        return InceptionV3({k: data[k] for k in data.files}).to(device)


def load_inception(path=None, device="cuda"):
    """The frozen network of the `.npz` at `path` (default: the
    environment's) on `device`, cached per file (and its modification
    time) and device."""
    p = weights_path(path)
    if not os.path.isfile(p):
        raise FileNotFoundError(
            f"no Inception weights at {p!r}: pass a path or set "
            f"{WEIGHTS_ENV}")
    return _net(os.path.abspath(p), os.path.getmtime(p),
                str(torch.device(device)))


def resize_bilinear(x, side):
    """NHWC images -> side x side, bilinear with half-pixel centres and no
    antialias (a no-op at that size already)."""
    if tuple(x.shape[1:3]) == (side, side):
        return x
    y = F.interpolate(x.permute(0, 3, 1, 2), size=(side, side),
                      mode="bilinear", align_corners=False, antialias=False)
    return y.permute(0, 2, 3, 1)


@torch.no_grad()
def inception_pool3_features(images, path=None):
    """pool3 features [B, 2048] (f32) of NHWC images in [0, 1] of any
    size, on the images' device."""
    x = resize_bilinear(torch.as_tensor(images).float(), SIDE)
    net = load_inception(path, x.device)
    return net(x.permute(0, 3, 1, 2).contiguous() * 2.0 - 1.0)


class FeatureStats:
    """Running (mu, sigma) of features, kept as their sum and the sum of
    their outer products in float64, so an evaluation can be resumed
    (`state_dict` / `load_state_dict`)."""

    def __init__(self, dim=DIM):
        self.n = 0
        self.s = np.zeros((dim,), np.float64)
        self.outer = np.zeros((dim, dim), np.float64)

    def update(self, feats):
        if torch.is_tensor(feats):
            feats = feats.detach().cpu().numpy()
        f = np.asarray(feats, np.float64)
        self.n += f.shape[0]
        self.s += f.sum(0)
        self.outer += f.T @ f

    def state_dict(self):
        return {"n": self.n, "s": self.s, "outer": self.outer}

    def load_state_dict(self, d):
        self.n, self.s, self.outer = int(d["n"]), d["s"], d["outer"]

    def finalize(self):
        if self.n < 2:
            raise ValueError("need >= 2 samples for covariance")
        mu = self.s / self.n
        # unbiased (ddof 1), as np.cov(rowvar=False)
        sigma = (self.outer - self.n * np.outer(mu, mu)) / (self.n - 1)
        return mu, sigma


def frechet_distance(mu1, sigma1, mu2, sigma2, eps=1e-6):
    """|mu1 - mu2|^2 + tr(S1 + S2 - 2 sqrt(S1 S2)) on the host (scipy);
    where sqrt(S1 S2) is not finite, again with eps * I added to both
    covariances (pytorch-fid's fallback)."""
    from scipy import linalg

    mu1, mu2 = np.atleast_1d(mu1), np.atleast_1d(mu2)
    sigma1, sigma2 = np.atleast_2d(sigma1), np.atleast_2d(sigma2)
    diff = mu1 - mu2
    covmean = linalg.sqrtm(sigma1 @ sigma2)
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = linalg.sqrtm((sigma1 + offset) @ (sigma2 + offset))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff @ diff + np.trace(sigma1) + np.trace(sigma2)
                 - 2.0 * np.trace(covmean))


def fid_from_features(feats1, feats2):
    """The Frechet distance between two feature arrays [N, D]."""
    s1, s2 = FeatureStats(feats1.shape[1]), FeatureStats(feats2.shape[1])
    s1.update(feats1)
    s2.update(feats2)
    return frechet_distance(*s1.finalize(), *s2.finalize())


def _fold_bn(sd, path, conv_key, eps):
    """(w * scale, beta - mean * scale) in float64 of a conv + BatchNorm,
    scale = gamma / sqrt(var + eps)."""
    w = sd[conv_key].numpy().astype(np.float64)
    gamma = sd[f"{path}.bn.weight"].numpy().astype(np.float64)
    beta = sd[f"{path}.bn.bias"].numpy().astype(np.float64)
    mean = sd[f"{path}.bn.running_mean"].numpy().astype(np.float64)
    var = sd[f"{path}.bn.running_var"].numpy().astype(np.float64)
    scale = gamma / np.sqrt(var + eps)
    return w * scale.reshape(-1, *[1] * (w.ndim - 1)), beta - mean * scale


def _load_state(state_path):
    sd = torch.load(state_path, map_location="cpu")
    return sd["state_dict"] if "state_dict" in sd else sd


def fold_inception(sd):
    """{path_w: HWIO f32, path_b: f32} of a torchvision-layout `Inception3`
    state dict: each BasicConv2d's conv and BatchNorm folded into one
    weight and a bias, in float64, then f32."""
    out = {}
    for path in _CONV_SPEC:
        w, b = _fold_bn(sd, path, f"{path}.conv.weight", _BN_EPS)
        out[f"{path}_w"] = w.transpose(2, 3, 1, 0).astype(np.float32)
        out[f"{path}_b"] = b.astype(np.float32)
    return out


def convert_torch_inception_npz(state_path, out_path):
    """Fold a torchvision-layout `Inception3` state dict (`.pth`) into the
    `.npz` the network reads, with the source's sha256
    (`__source_sha256__`). The JAX package's converter writes the same
    arrays."""
    out = fold_inception(_load_state(state_path))
    out["__source_sha256__"] = file_sha256(state_path)
    np.savez(out_path, **out)
    return out_path


def randomise_bn_(sd, path, cout, g):
    """Seeded BatchNorm parameters and statistics of `path` (gamma and
    the variance in [0.5, 1.5), beta and the mean N(0, 0.1)), as the JAX
    package's FID and FVD tests randomise them, so a fold is exercised."""
    sd[f"{path}.bn.weight"] = torch.rand(cout, generator=g) + 0.5
    sd[f"{path}.bn.bias"] = torch.randn(cout, generator=g) * 0.1
    sd[f"{path}.bn.running_mean"] = torch.randn(cout, generator=g) * 0.1
    sd[f"{path}.bn.running_var"] = torch.rand(cout, generator=g) + 0.5
    sd[f"{path}.bn.num_batches_tracked"] = torch.tensor(0)


def random_inception_state_dict(seed=0):
    """A seeded torchvision-layout `Inception3` state dict (the 94
    BasicConv2d's): He-scaled conv weights, so the features stay O(1),
    and randomised BatchNorms: a stand-in for the real weights, whose FID
    measures nothing."""
    g = torch.Generator().manual_seed(seed)
    sd = {}
    for path, cin, cout, (kh, kw), _, _ in _ALL_CONVS:
        sd[f"{path}.conv.weight"] = torch.randn(
            cout, cin, kh, kw, generator=g) * (2.0 / (cin * kh * kw)) ** 0.5
        randomise_bn_(sd, path, cout, g)
    return sd


def save_random_inception_npz(out_path, seed=0):
    """The folded `random_inception_state_dict(seed)` as an `.npz` with no
    source sha: its metrics print as `fid(untrained-weights)`."""
    np.savez(out_path, **fold_inception(random_inception_state_dict(seed)))
    return out_path
