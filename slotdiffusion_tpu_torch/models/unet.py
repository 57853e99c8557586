"""Slot-conditioned denoising UNet, NCHW (mirrors the JAX package's models/
unet.py:54-125, 127-420, 478-619). Parameter names follow the upstream
LDM UNet (input_blocks / middle_block / output_blocks / out), the names
the JAX package's exporter writes.

The flagship sets `fused_gn=True` (every ResBlock GN+SiLU and every
SpatialTransformer GN runs the GN kernel) and `attn_backend="fused"`
(every self- and cross-attention runs the attention kernel, which ignores
`attn_softmax` as the JAX package's fused backend does).
"""

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention_kernel import fused_mha
from .blocks import GroupNorm32, timestep_embedding


def _attention(q, k, v, num_heads, backend="einsum", softmax="fast"):
    """q [B, Nq, H*D], k/v [B, Nk, H*D] -> [B, Nq, H*D]."""
    if backend == "fused":
        return fused_mha(q, k, v, num_heads)
    if backend != "einsum":
        raise ValueError(f"attention backend {backend!r} is not ported")
    B, Nq, HD = q.shape
    Nk = k.shape[1]
    D = HD // num_heads
    qh = q.reshape(B, Nq, num_heads, D).transpose(1, 2)
    kh = k.reshape(B, Nk, num_heads, D).transpose(1, 2)
    vh = v.reshape(B, Nk, num_heads, D).transpose(1, 2)
    logits = (qh @ kh.transpose(-1, -2)) * D ** -0.5
    if softmax == "fast":  # the JAX package's clip-exp softmax
        e = torch.exp(torch.clamp(logits, -60.0, 60.0))
        w = e / e.sum(-1, keepdim=True)
    else:
        w = torch.softmax(logits, dim=-1)
    return (w @ vh).transpose(1, 2).reshape(B, Nq, HD)


class CrossAttention(nn.Module):
    """Q from x, K/V from the context (or x); no-bias projections."""

    def __init__(self, query_dim, context_dim, num_heads, head_dim,
                 attn_backend, attn_softmax):
        super().__init__()
        inner = num_heads * head_dim
        context_dim = context_dim or query_dim
        self.num_heads = num_heads
        self.backend, self.softmax = attn_backend, attn_softmax
        self.to_q = nn.Linear(query_dim, inner, bias=False)
        self.to_k = nn.Linear(context_dim, inner, bias=False)
        self.to_v = nn.Linear(context_dim, inner, bias=False)
        self.to_out = nn.Sequential(nn.Linear(inner, query_dim))

    def forward(self, x, context=None):
        ctx = x if context is None else context
        out = _attention(self.to_q(x), self.to_k(ctx), self.to_v(ctx),
                         self.num_heads, self.backend, self.softmax)
        return self.to_out(out)


class GEGLU(nn.Module):
    def __init__(self, dim_in, dim_out):
        super().__init__()
        self.proj = nn.Linear(dim_in, dim_out * 2)

    def forward(self, x):
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate)  # exact erf form, f32


class _FeedForward(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.net = nn.Sequential(GEGLU(dim, dim * 4), nn.Identity(),
                                 nn.Linear(dim * 4, dim))

    def forward(self, x):
        return self.net(x)


class TransformerBlock(nn.Module):
    """Pre-norm self-attention -> cross-attention -> GEGLU FFN."""

    def __init__(self, dim, num_heads, head_dim, context_dim, attn_backend,
                 attn_softmax):
        super().__init__()
        kw = dict(num_heads=num_heads, head_dim=head_dim,
                  attn_backend=attn_backend, attn_softmax=attn_softmax)
        self.attn1 = CrossAttention(dim, None, **kw)
        self.attn2 = CrossAttention(dim, context_dim, **kw)
        self.norm1 = nn.LayerNorm(dim)
        self.norm2 = nn.LayerNorm(dim)
        self.norm3 = nn.LayerNorm(dim)
        self.ff = _FeedForward(dim)

    def forward(self, x, context=None):
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context)
        return x + self.ff(self.norm3(x))


class SpatialTransformer(nn.Module):
    """GN (eps 1e-6) -> 1x1 proj -> transformer blocks over the pixels ->
    1x1 proj, residual."""

    def __init__(self, channels, num_heads, head_dim, depth, context_dim,
                 attn_backend, attn_softmax, fused_gn):
        super().__init__()
        self.norm = GroupNorm32(channels, eps=1e-6, fused=fused_gn)
        self.proj_in = nn.Conv2d(channels, channels, 1)
        self.transformer_blocks = nn.ModuleList([
            TransformerBlock(channels, num_heads, head_dim, context_dim,
                             attn_backend, attn_softmax)
            for _ in range(depth)])
        self.proj_out = nn.Conv2d(channels, channels, 1)

    def forward(self, x, context=None):
        B, C, H, W = x.shape
        h = self.proj_in(self.norm(x))
        h = h.permute(0, 2, 3, 1).reshape(B, H * W, C)
        for blk in self.transformer_blocks:
            h = blk(h, context)
        h = h.reshape(B, H, W, C).permute(0, 3, 1, 2).contiguous()
        return x + self.proj_out(h)


class ResBlock(nn.Module):
    """GN+SiLU -> conv3x3, + time-embedding, GN+SiLU -> conv3x3, residual
    with a 1x1 skip on a channel change. A decoder block takes the
    channel-concat of h and its skip."""

    def __init__(self, channels, out_channels, emb_channels, dropout=0.0,
                 fused_gn=False):
        super().__init__()
        self.in_layers = nn.Sequential(
            GroupNorm32(channels, act="silu", fused=fused_gn), nn.Identity(),
            nn.Conv2d(channels, out_channels, 3, padding=1))
        self.emb_layers = nn.Sequential(nn.SiLU(),
                                        nn.Linear(emb_channels, out_channels))
        self.out_layers = nn.Sequential(
            GroupNorm32(out_channels, act="silu", fused=fused_gn),
            nn.Identity(), nn.Dropout(dropout),
            nn.Conv2d(out_channels, out_channels, 3, padding=1))
        self.skip_connection = nn.Identity() if channels == out_channels \
            else nn.Conv2d(channels, out_channels, 1)

    def forward(self, x, emb):
        h = self.in_layers(x)
        h = h + self.emb_layers(emb)[:, :, None, None]
        return self.skip_connection(x) + self.out_layers(h)


class Downsample(nn.Module):
    def __init__(self, channels):
        super().__init__()
        self.op = nn.Conv2d(channels, channels, 3, stride=2, padding=1)

    def forward(self, x):
        return self.op(x)


class Upsample(nn.Module):
    """nearest-2x followed by a 3x3 conv, computed as the JAX package's
    `_PhaseUpConv` does: four 2x2 convs on the coarse grid whose taps are
    sums of the 3x3 taps, interleaved depth-to-space. Exact in real
    arithmetic; parameters are the 3x3 conv's (`conv`)."""

    def __init__(self, channels):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, padding=1)

    def forward(self, x):
        W = self.conv.weight  # [F, C, 3, 3]
        rows = {0: (W[:, :, 0], W[:, :, 1] + W[:, :, 2]),
                1: (W[:, :, 0] + W[:, :, 1], W[:, :, 2])}  # [F, C, 3]

        def cols(Wr, b):
            return {0: (Wr[..., 0], Wr[..., 1] + Wr[..., 2]),
                    1: (Wr[..., 0] + Wr[..., 1], Wr[..., 2])}[b]

        outs = []
        for a in (0, 1):
            for b in (0, 1):
                r0, r1 = rows[a]
                c00, c01 = cols(r0, b)
                c10, c11 = cols(r1, b)
                k = torch.stack([torch.stack([c00, c01], -1),
                                 torch.stack([c10, c11], -1)], -2)
                xp = F.pad(x, (1 - b, b, 1 - a, a))
                outs.append(F.conv2d(xp, k))
        B, Fo, H, Wd = outs[0].shape
        z = torch.stack(outs, 0).reshape(2, 2, B, Fo, H, Wd)
        z = z.permute(2, 3, 4, 0, 5, 1).reshape(B, Fo, 2 * H, 2 * Wd)
        return z + self.conv.bias[None, :, None, None]


class UNetModel(nn.Module):
    """Denoising UNet: NCHW x [B, C, H, W], timesteps [B], context
    [B, S, D] -> [B, out_channels, H, W]. Keys mirror `unet_dict`."""

    def __init__(self, in_channels, model_channels, out_channels,
                 num_res_blocks, attention_resolutions, dropout=0.0,
                 channel_mult=(1, 2, 4, 8), num_head_channels=32,
                 transformer_depth=1, context_dim=None,
                 attn_backend="einsum", attn_softmax="fast", fused_gn=False):
        super().__init__()
        mc = model_channels
        self.model_channels = mc
        emb = mc * 4
        self.time_embed = nn.Sequential(nn.Linear(mc, emb), nn.SiLU(),
                                        nn.Linear(emb, emb))

        def res(ci, co):
            return ResBlock(ci, co, emb, dropout, fused_gn)

        def attn(ch):
            return SpatialTransformer(
                ch, ch // num_head_channels, num_head_channels,
                transformer_depth, context_dim, attn_backend, attn_softmax,
                fused_gn)

        self.input_blocks = nn.ModuleList([nn.ModuleList([
            nn.Conv2d(in_channels, mc, 3, padding=1)])])
        chans = [mc]
        ch, ds = mc, 1
        for level, mult in enumerate(channel_mult):
            for _ in range(num_res_blocks):
                layers = [res(ch, mult * mc)]
                ch = mult * mc
                if ds in attention_resolutions:
                    layers.append(attn(ch))
                self.input_blocks.append(nn.ModuleList(layers))
                chans.append(ch)
            if level != len(channel_mult) - 1:
                self.input_blocks.append(nn.ModuleList([Downsample(ch)]))
                chans.append(ch)
                ds *= 2
        self.middle_block = nn.ModuleList([res(ch, ch), attn(ch),
                                           res(ch, ch)])
        self.output_blocks = nn.ModuleList()
        for level in reversed(range(len(channel_mult))):
            for i in range(num_res_blocks + 1):
                layers = [res(ch + chans.pop(), mc * channel_mult[level])]
                ch = mc * channel_mult[level]
                if ds in attention_resolutions:
                    layers.append(attn(ch))
                if level and i == num_res_blocks:
                    layers.append(Upsample(ch))
                    ds //= 2
                self.output_blocks.append(nn.ModuleList(layers))
        self.out = nn.Sequential(
            GroupNorm32(mc, act="silu", fused=fused_gn), nn.Identity(),
            nn.Conv2d(mc, out_channels, 3, padding=1))

    @staticmethod
    def _run(block, h, emb, context):
        for layer in block:
            if isinstance(layer, ResBlock):
                h = layer(h, emb)
            elif isinstance(layer, SpatialTransformer):
                h = layer(h, context)
            else:
                h = layer(h)
        return h

    def forward(self, x, timesteps, context=None):
        emb = self.time_embed(timestep_embedding(timesteps,
                                                 self.model_channels))
        hs = []
        h = x.float()
        for block in self.input_blocks:
            h = self._run(block, h, emb, context)
            hs.append(h)
        h = self._run(self.middle_block, h, emb, context)
        for block in self.output_blocks:
            h = self._run(block, torch.cat([h, hs.pop()], dim=1), emb,
                          context)
        return self.out(h)
