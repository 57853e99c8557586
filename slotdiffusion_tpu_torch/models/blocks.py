"""Shared building blocks, NCHW (mirrors the JAX package's models/blocks.py:
31-193, 237-313)."""

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.fused_norm import fused_group_norm, group_norm_reference


class GroupNorm32(nn.GroupNorm):
    """GroupNorm with f32 statistics and an optional fused SiLU.

    `fused=True` routes the call through the GN(+SiLU) kernel
    (ops/fused_norm.py), the JAX `fused_gn` knob; `fused=False` is the
    plain formula. eps is set per call site: 1e-5 by default, 1e-6 in the
    UNet's SpatialTransformer and the VQ-VAE. Parameters are torch
    GroupNorm's `weight`/`bias`."""

    def __init__(self, channels, num_groups=32, eps=1e-5, act=None,
                 fused=False):
        num_groups = min(num_groups, channels)
        while channels % num_groups:
            num_groups -= 1
        super().__init__(num_groups, channels, eps=eps)
        self.act = act
        self.fused = fused

    def forward(self, x):
        fn = fused_group_norm if self.fused else group_norm_reference
        return fn(x, self.weight, self.bias, self.num_groups, self.eps,
                  self.act)


def timestep_embedding(timesteps, dim, max_period=10000):
    """[B] timesteps -> [B, dim] f32 sinusoidal embedding, cos half first."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=timesteps.device) / half)
    args = timesteps.float()[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = nn.functional.pad(emb, (0, 1))
    return emb


def build_grid(resolution, device=None):
    """[1, H, W, 4] grid of (y, x, 1 - y, 1 - x) in [0, 1]."""
    h, w = resolution
    ys = torch.linspace(0.0, 1.0, h, device=device)
    xs = torch.linspace(0.0, 1.0, w, device=device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    grid = torch.stack([gy, gx], dim=-1)[None]
    return torch.cat([grid, 1.0 - grid], dim=-1)


class SoftPositionEmbed(nn.Module):
    """Adds a learned linear projection of the coordinate grid to an NHWC
    feature map (parameters: `dense`)."""

    def __init__(self, hidden_size):
        super().__init__()
        self.dense = nn.Linear(4, hidden_size)

    def forward(self, inputs):
        return inputs + self.dense(build_grid(inputs.shape[1:3],
                                              inputs.device))


class MLP(nn.Sequential):
    """Dense layers with an activation between them, optional pre-LN."""

    def __init__(self, in_dim, hidden_dims, out_dim, act=nn.ReLU,
                 pre_norm=False):
        layers = [nn.LayerNorm(in_dim)] if pre_norm else []
        for d in hidden_dims:
            layers += [nn.Linear(in_dim, d), act()]
            in_dim = d
        layers.append(nn.Linear(in_dim, out_dim))
        super().__init__(*layers)


class ChannelLayerNorm(nn.LayerNorm):
    """LayerNorm over the channels of an NCHW map (flax's LayerNorm on the
    last axis of NHWC), eps 1e-5."""

    def forward(self, x):
        return super().forward(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


def get_norm(norm, channels):
    """A norm name -> its module over `channels` (None for ""), as the JAX
    package's `get_norm`: GroupNorm32 with 32 groups or LayerNorm."""
    if not norm:
        return None
    if norm in ("gn", "group_norm", "groupnorm"):
        return GroupNorm32(channels)
    if norm in ("ln", "layer_norm", "layernorm"):
        return ChannelLayerNorm(channels, eps=1e-5)
    raise ValueError(f"unsupported norm: {norm!r}")


def get_act(act):
    """An activation name -> its module (None for ""), as the JAX
    package's `get_act` (flax's gelu is the tanh approximation)."""
    if not act:
        return None
    return {
        "relu": nn.ReLU,
        "silu": nn.SiLU,
        "swish": nn.SiLU,
        "gelu": lambda: nn.GELU(approximate="tanh"),
        "tanh": nn.Tanh,
        "sigmoid": nn.Sigmoid,
        "leakyrelu": lambda: nn.LeakyReLU(0.2),
    }[act]()


def same_padding(size, kernel, stride):
    """flax `padding="SAME"` on one axis: (before, after) so that the
    output has ceil(size / stride) positions. The two differ when
    (kernel - stride) is odd or `size` does not divide by `stride`: k = 5
    at stride 2 on an even input pads 1 before and 2 after."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class ConvNormAct(nn.Sequential):
    """Conv2d -> norm -> activation with flax's "SAME" padding, NCHW (the
    JAX package's ConvNormAct). Modules `0` (conv), `1` (norm or
    Identity), `2` (activation or Identity), as upstream's
    `conv_norm_act` names them."""

    def __init__(self, in_channels, out_channels, kernel_size=3, stride=1,
                 norm="", act="relu"):
        super().__init__(
            nn.Conv2d(in_channels, out_channels, kernel_size, stride),
            get_norm(norm, out_channels) or nn.Identity(),
            get_act(act) or nn.Identity())

    def forward(self, x):
        conv = self[0]
        (t, b), (l, r) = (same_padding(n, k, s) for n, k, s in zip(
            x.shape[2:], conv.kernel_size, conv.stride))
        return self[2](self[1](conv(F.pad(x, (l, r, t, b)))))
