"""The frozen DINO ViT encoder (mirrors the JAX package's models/dino.py:
27-87, 167-181): a self-supervised ViT (facebook/dino-vits8: 384
channels, 6 heads; ViT-B: 768 and 12; depth 12) whose patch tokens, the
CLS token stripped, come back as a [B, H/p, W/p, C] feature map.

- Patch embedding as a strided conv, a zero-initialized CLS token and a
  learned `position_embeddings` of h*w + 1 rows (no interpolation: the
  encoder runs at the resolution it was built for).
- Each block: LayerNorm (eps 1e-6) -> multi-head attention -> residual,
  LayerNorm -> Dense(4C) -> GELU -> Dense(C) -> residual. Attention is a
  plain matmul + softmax, as flax's `MultiHeadDotProductAttention`
  computes it (the query scaled by 1/sqrt(head_dim) first). The GELU is
  the exact erf form in f32 and the tanh form under bf16, as the JAX
  block switches, evaluated op by op in bf16 as `jax.nn.gelu` is
  (`gelu_tanh`). A final LayerNorm.
- Parameter names are the HF `ViTModel`'s (`embeddings.cls_token`,
  `encoder.layer.{i}.attention.attention.query`, ...), which upstream
  holds under `encoder.dino.`, so a reference checkpoint maps by prefix.
- Frozen: the model that holds it lists it in `frozen_modules` (no
  gradient, no optimizer state) and `DINOBackbone` runs it under
  `torch.no_grad`, as the JAX model's `stop_gradient` gives its weights
  no update.

`load_dino_weights` overlays pretrained weights from the `.npz` of
flattened flax paths that `SLOTDIFFUSION_DINO_WEIGHTS` names (the JAX
package's format, `convert_hf_dino_npz`); without the file the encoder
keeps its seeded weights. It never fetches anything.
"""

import math
import os

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .blocks import Conv2d, LayerNorm, Linear

WEIGHTS_ENV = "SLOTDIFFUSION_DINO_WEIGHTS"
DEPTH = 12


def vit_size(small_size=True):
    """-> (channels, heads) of ViT-S or ViT-B."""
    return (384, 6) if small_size else (768, 12)


def gelu_tanh(x):
    """The tanh GELU in x's dtype, one rounding an op in the order of
    `jax.nn.gelu(approximate=True)`: x * 0.5 * (1 + tanh(sqrt(2/pi) *
    (x + 0.044715 * x^3))) (torch's own rounds once, from f32)."""
    cdf = 0.5 * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) *
                                  (x + 0.044715 * (x * x * x))))
    return x * cdf


class _Dense(nn.Module):
    """One `dense` Linear (the HF names' extra level)."""

    def __init__(self, cin, cout, compute_dtype):
        super().__init__()
        self.dense = Linear(cin, cout, compute_dtype=compute_dtype)

    def forward(self, x):
        return self.dense(x)


class _SelfAttention(nn.Module):
    def __init__(self, dim, compute_dtype):
        super().__init__()
        dt = dict(compute_dtype=compute_dtype)
        self.query = Linear(dim, dim, **dt)
        self.key = Linear(dim, dim, **dt)
        self.value = Linear(dim, dim, **dt)


class _Attention(nn.Module):
    """flax `MultiHeadDotProductAttention` over [B, N, C] in the compute
    dtype: q / sqrt(hd), q k^T, a softmax rounded where jax.nn.softmax
    rounds (the difference, the exponential, the quotient), the weighted
    values, the output projection."""

    def __init__(self, dim, heads, compute_dtype):
        super().__init__()
        self.heads = heads
        self.attention = _SelfAttention(dim, compute_dtype)
        self.output = _Dense(dim, dim, compute_dtype)

    def forward(self, x):
        B, N, C = x.shape
        hd = C // self.heads
        a = self.attention
        split = lambda t: t.reshape(B, N, self.heads, hd).transpose(1, 2)
        q = split(a.query(x)) / math.sqrt(hd)
        k, v = split(a.key(x)), split(a.value(x))
        s = q @ k.transpose(-1, -2)
        e = torch.exp(s - s.amax(-1, keepdim=True))
        w = e / e.sum(-1, keepdim=True)
        out = (w @ v).transpose(1, 2).reshape(B, N, C)
        return self.output(out)


class ViTBlock(nn.Module):
    """A pre-LN ViT block (LayerNorm eps 1e-6, the DINO ViT's)."""

    def __init__(self, dim, heads, mlp_ratio=4, compute_dtype=torch.float32):
        super().__init__()
        dt = dict(compute_dtype=compute_dtype)
        self.layernorm_before = LayerNorm(dim, eps=1e-6, **dt)
        self.attention = _Attention(dim, heads, compute_dtype)
        self.layernorm_after = LayerNorm(dim, eps=1e-6, **dt)
        self.intermediate = _Dense(dim, dim * mlp_ratio, compute_dtype)
        self.output = _Dense(dim * mlp_ratio, dim, compute_dtype)
        # exact erf GELU in f32; the tanh form under bf16, as the JAX block
        self.approximate = "none" if compute_dtype == torch.float32 \
            else "tanh"

    def forward(self, x):
        x = x + self.attention(self.layernorm_before(x))
        h = self.intermediate(self.layernorm_after(x))
        h = gelu_tanh(h) if self.approximate == "tanh" else F.gelu(h)
        return x + self.output(h)


class _PatchEmbeddings(nn.Module):
    def __init__(self, dim, patch_size, compute_dtype):
        super().__init__()
        self.projection = Conv2d(3, dim, patch_size, stride=patch_size,
                                 compute_dtype=compute_dtype)


class _Embeddings(nn.Module):
    def __init__(self, dim, patch_size, num_patches, compute_dtype):
        super().__init__()
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.position_embeddings = nn.Parameter(
            torch.zeros(1, num_patches + 1, dim))
        self.patch_embeddings = _PatchEmbeddings(dim, patch_size,
                                                 compute_dtype)


class _Encoder(nn.Module):
    def __init__(self, dim, heads, depth, compute_dtype):
        super().__init__()
        self.layer = nn.ModuleList(
            ViTBlock(dim, heads, compute_dtype=compute_dtype)
            for _ in range(depth))


class DINOEncoder(nn.Module):
    """NHWC images [B, H, W, 3] at `resolution` -> patch-token features
    [B, H/p, W/p, C] in the compute dtype (ViT-S/B, patch `patch_size`)."""

    def __init__(self, resolution, patch_size=8, small_size=True,
                 depth=DEPTH, compute_dtype=torch.float32):
        super().__init__()
        self.dim, self.heads = vit_size(small_size)
        self.patch_size = patch_size
        self.grid = (resolution[0] // patch_size, resolution[1] // patch_size)
        self.compute_dtype = compute_dtype
        self.embeddings = _Embeddings(self.dim, patch_size,
                                      self.grid[0] * self.grid[1],
                                      compute_dtype)
        self.encoder = _Encoder(self.dim, self.heads, depth, compute_dtype)
        self.layernorm = LayerNorm(self.dim, eps=1e-6,
                                   compute_dtype=compute_dtype)

    def forward(self, img):
        B = img.shape[0]
        dt, emb = self.compute_dtype, self.embeddings
        x = emb.patch_embeddings.projection(
            img.permute(0, 3, 1, 2).contiguous())  # [B, C, h, w]
        h, w = x.shape[2:]
        if (h, w) != self.grid:
            raise ValueError(f"DINO built for {self.grid} patches, got "
                             f"{(h, w)}: its position embedding is not "
                             "interpolated")
        x = x.flatten(2).transpose(1, 2)
        cls = emb.cls_token.to(dt).expand(B, 1, self.dim)
        x = torch.cat([cls, x], 1) + emb.position_embeddings.to(dt)
        for blk in self.encoder.layer:
            x = blk(x)
        x = self.layernorm(x)
        return x[:, 1:].reshape(B, h, w, self.dim)


class DINOBackbone(nn.Module):
    """The SA encoder's backbone: `dino`, run without gradients."""

    def __init__(self, enc_dict, resolution, compute_dtype=torch.float32):
        super().__init__()
        self.dino = DINOEncoder(tuple(resolution),
                                enc_dict.get("patch_size", 8),
                                enc_dict.get("small_size", True),
                                compute_dtype=compute_dtype)
        self.out_channels = self.dino.dim

    def forward(self, img):
        with torch.no_grad():
            return self.dino(img)


def flax_names(depth=DEPTH):
    """{flattened flax path of the JAX DINOEncoder: (port name, its layout
    change)}: "conv" ([kh, kw, C, F] -> [F, C, kh, kw]), "dense" ([in,
    out] -> [out, in]), "qkv" ([in, heads, hd] -> [out, in]), "qkv_bias"
    ([heads, hd] -> [out]), "out" ([heads, hd, out] -> [out, in]), or
    None (as it is)."""
    names = {
        "cls_token": ("embeddings.cls_token", None),
        "pos_embed": ("embeddings.position_embeddings", None),
        "patch_embed/kernel": ("embeddings.patch_embeddings.projection"
                               ".weight", "conv"),
        "patch_embed/bias": ("embeddings.patch_embeddings.projection.bias",
                             None),
        "LayerNorm_0/scale": ("layernorm.weight", None),
        "LayerNorm_0/bias": ("layernorm.bias", None),
    }
    for i in range(depth):
        b, p = f"block{i}", f"encoder.layer.{i}"
        for j, side in ((0, "before"), (1, "after")):
            names[f"{b}/LayerNorm_{j}/scale"] = (
                f"{p}.layernorm_{side}.weight", None)
            names[f"{b}/LayerNorm_{j}/bias"] = (f"{p}.layernorm_{side}.bias",
                                                None)
        for n in ("query", "key", "value"):
            names[f"{b}/attn/{n}/kernel"] = (
                f"{p}.attention.attention.{n}.weight", "qkv")
            names[f"{b}/attn/{n}/bias"] = (
                f"{p}.attention.attention.{n}.bias", "qkv_bias")
        names[f"{b}/attn/out/kernel"] = (f"{p}.attention.output.dense.weight",
                                         "out")
        names[f"{b}/attn/out/bias"] = (f"{p}.attention.output.dense.bias",
                                       None)
        for j, sub in ((0, "intermediate"), (1, "output")):
            names[f"{b}/Dense_{j}/kernel"] = (f"{p}.{sub}.dense.weight",
                                              "dense")
            names[f"{b}/Dense_{j}/bias"] = (f"{p}.{sub}.dense.bias", None)
    return names


def relayout(v, how):
    """One flax leaf in the port's layout (see `flax_names`)."""
    v = np.asarray(v)
    if how == "conv":
        return np.transpose(v, (3, 2, 0, 1))
    if how == "dense":
        return np.transpose(v)
    if how == "qkv":
        return np.transpose(v.reshape(v.shape[0], -1))
    if how == "qkv_bias":
        return v.reshape(-1)
    if how == "out":
        return np.transpose(v.reshape(-1, v.shape[-1]))
    return v


def convert_flat(flat, depth=DEPTH):
    """{flattened flax path: array} of a JAX DINOEncoder -> the port's
    {name: array}; KeyError names a path the dict lacks."""
    return {name: relayout(flat[path], how)
            for path, (name, how) in flax_names(depth).items()}


def load_dino_weights(module):
    """Overlay the pretrained weights of the `.npz` that
    SLOTDIFFUSION_DINO_WEIGHTS names onto the DINOEncoder `module` (in
    place). -> (module, loaded): unchanged and False when the variable is
    unset or names no file. Raises ValueError for a file whose keys do not
    cover the encoder, or whose shapes differ."""
    path = os.environ.get(WEIGHTS_ENV, "")
    if not path or not os.path.isfile(path):
        return module, False
    depth = len(module.encoder.layer)
    with np.load(path) as data:
        missing = [k for k in flax_names(depth) if k not in data.files]
        if missing:
            raise ValueError(f"{path} ({WEIGHTS_ENV}) lacks {len(missing)} "
                             f"DINO weights: {missing[:4]}")
        sd = convert_flat({k: data[k] for k in flax_names(depth)}, depth)
    own = module.state_dict()
    for name, v in sd.items():
        if tuple(v.shape) != tuple(own[name].shape):
            raise ValueError(f"{path}: {name} has shape {v.shape}, the "
                             f"encoder {tuple(own[name].shape)}")
    module.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v))
                            for k, v in sd.items()}, strict=True)
    return module, True
