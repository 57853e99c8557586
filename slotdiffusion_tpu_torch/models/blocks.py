"""Shared building blocks, NCHW (mirrors the JAX package's models/blocks.py:
31-135, 237-313)."""

import math

import torch
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
