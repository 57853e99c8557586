"""Slot-conditioned denoising UNet, NCHW (mirrors the JAX package's models/
unet.py:54-125, 127-420, 478-619). Parameter names follow the upstream
LDM UNet (input_blocks / middle_block / output_blocks / out), the names
the JAX package's exporter writes.

The flagship sets `fused_gn=True` (every ResBlock GN+SiLU and every
SpatialTransformer GN runs the GN kernel) and `attn_backend="fused"`
(every self- and cross-attention runs the attention kernel, which ignores
`attn_softmax` as the JAX package's fused backend does).

Every layer computes in `compute_dtype` (bf16 under `use_bf16`, with f32
parameters), as the JAX UNet does in its `dtype`: the einsum attention
takes f32 logits and softmax and casts the weights to the compute dtype
for the value product; GEGLU takes the tanh GELU under bf16; the
phase-conv Upsample sums its taps in f32 before the cast; the output conv
runs in f32 (`conv_out_compute="f32"`) or on bf16 operands with an f32
output (`"bf16"`, `ConvOutBf16Acc`).
"""

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention_kernel import fused_mha
from .blocks import Conv2d, GroupNorm32, LayerNorm, Linear, add_bias, \
    timestep_embedding


def _attention(q, k, v, num_heads, backend="einsum", softmax="fast"):
    """q [B, Nq, H*D], k/v [B, Nk, H*D] -> [B, Nq, H*D] in q's dtype."""
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
    # f32 logits and softmax; the weights in q's dtype for an f32-summed
    # value product (the JAX einsums' preferred_element_type=f32)
    logits = (qh.float() @ kh.float().transpose(-1, -2)) * D ** -0.5
    if softmax == "fast":  # the JAX package's clip-exp softmax
        e = torch.exp(torch.clamp(logits, -60.0, 60.0))
        w = e / e.sum(-1, keepdim=True)
    else:
        w = torch.softmax(logits, dim=-1)
    out = w.to(q.dtype).float() @ vh.float()
    return out.to(q.dtype).transpose(1, 2).reshape(B, Nq, HD)


class CrossAttention(nn.Module):
    """Q from x, K/V from the context (or x); no-bias projections."""

    def __init__(self, query_dim, context_dim, num_heads, head_dim,
                 attn_backend, attn_softmax, compute_dtype=torch.float32):
        super().__init__()
        inner = num_heads * head_dim
        context_dim = context_dim or query_dim
        dt = dict(compute_dtype=compute_dtype)
        self.num_heads = num_heads
        self.backend, self.softmax = attn_backend, attn_softmax
        self.to_q = Linear(query_dim, inner, bias=False, **dt)
        self.to_k = Linear(context_dim, inner, bias=False, **dt)
        self.to_v = Linear(context_dim, inner, bias=False, **dt)
        self.to_out = nn.Sequential(Linear(inner, query_dim, **dt))

    def forward(self, x, context=None):
        ctx = x if context is None else context
        out = _attention(self.to_q(x), self.to_k(ctx), self.to_v(ctx),
                         self.num_heads, self.backend, self.softmax)
        return self.to_out(out)


class GEGLU(nn.Module):
    """The exact erf GELU in f32; under bf16 the tanh form, as the JAX
    GEGLU takes it there."""

    def __init__(self, dim_in, dim_out, compute_dtype=torch.float32):
        super().__init__()
        self.proj = Linear(dim_in, dim_out * 2, compute_dtype=compute_dtype)
        self.approximate = "none" if compute_dtype == torch.float32 \
            else "tanh"

    def forward(self, x):
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate, approximate=self.approximate)


class _FeedForward(nn.Module):
    def __init__(self, dim, compute_dtype=torch.float32):
        super().__init__()
        self.net = nn.Sequential(
            GEGLU(dim, dim * 4, compute_dtype), nn.Identity(),
            Linear(dim * 4, dim, compute_dtype=compute_dtype))

    def forward(self, x):
        return self.net(x)


class TransformerBlock(nn.Module):
    """Pre-norm self-attention -> cross-attention -> GEGLU FFN."""

    def __init__(self, dim, num_heads, head_dim, context_dim, attn_backend,
                 attn_softmax, compute_dtype=torch.float32):
        super().__init__()
        dt = dict(compute_dtype=compute_dtype)
        kw = dict(num_heads=num_heads, head_dim=head_dim,
                  attn_backend=attn_backend, attn_softmax=attn_softmax, **dt)
        self.attn1 = CrossAttention(dim, None, **kw)
        self.attn2 = CrossAttention(dim, context_dim, **kw)
        self.norm1 = LayerNorm(dim, **dt)
        self.norm2 = LayerNorm(dim, **dt)
        self.norm3 = LayerNorm(dim, **dt)
        self.ff = _FeedForward(dim, compute_dtype)

    def forward(self, x, context=None):
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context)
        return x + self.ff(self.norm3(x))


class SpatialTransformer(nn.Module):
    """GN (eps 1e-6) -> 1x1 proj -> transformer blocks over the pixels ->
    1x1 proj, residual."""

    def __init__(self, channels, num_heads, head_dim, depth, context_dim,
                 attn_backend, attn_softmax, fused_gn,
                 compute_dtype=torch.float32):
        super().__init__()
        dt = dict(compute_dtype=compute_dtype)
        self.norm = GroupNorm32(channels, eps=1e-6, fused=fused_gn)
        self.proj_in = Conv2d(channels, channels, 1, **dt)
        self.transformer_blocks = nn.ModuleList([
            TransformerBlock(channels, num_heads, head_dim, context_dim,
                             attn_backend, attn_softmax, **dt)
            for _ in range(depth)])
        self.proj_out = Conv2d(channels, channels, 1, **dt)

    def forward(self, x, context=None):
        B, C, H, W = x.shape
        h = self.proj_in(self.norm(x))
        h = h.permute(0, 2, 3, 1).reshape(B, H * W, C)
        for blk in self.transformer_blocks:
            h = blk(h, context)
        h = h.reshape(B, H, W, C).permute(0, 3, 1, 2).contiguous()
        return x + self.proj_out(h)


class Dropout(nn.Module):
    """Dropout whose mask comes from the caller's `torch.Generator`, so a
    seeded run repeats; off in eval mode. In train mode with p > 0 it
    needs the generator (the JAX package draws it from the `dropout`
    rng stream)."""

    def __init__(self, p):
        super().__init__()
        self.p = p

    def forward(self, x, generator=None):
        if not self.training or self.p == 0:
            return x
        if generator is None:
            raise ValueError("dropout in train mode needs a torch.Generator")
        keep = torch.rand(x.shape, generator=generator, device=x.device) \
            >= self.p
        return x * keep / (1.0 - self.p)


class ResBlock(nn.Module):
    """GN+SiLU -> conv3x3, + time-embedding, GN+SiLU -> dropout ->
    conv3x3, residual with a 1x1 skip on a channel change. A decoder
    block takes the channel-concat of h and its skip."""

    def __init__(self, channels, out_channels, emb_channels, dropout=0.0,
                 fused_gn=False, compute_dtype=torch.float32):
        super().__init__()
        dt = dict(compute_dtype=compute_dtype)
        self.in_layers = nn.Sequential(
            GroupNorm32(channels, act="silu", fused=fused_gn), nn.Identity(),
            Conv2d(channels, out_channels, 3, padding=1, **dt))
        self.emb_layers = nn.Sequential(
            nn.SiLU(), Linear(emb_channels, out_channels, **dt))
        self.out_layers = nn.Sequential(
            GroupNorm32(out_channels, act="silu", fused=fused_gn),
            nn.Identity(), Dropout(dropout),
            Conv2d(out_channels, out_channels, 3, padding=1, **dt))
        self.skip_connection = nn.Identity() if channels == out_channels \
            else Conv2d(channels, out_channels, 1, **dt)

    def forward(self, x, emb, generator=None):
        h = self.in_layers(x)
        h = h + self.emb_layers(emb)[:, :, None, None]
        norm, _, drop, conv = self.out_layers
        return self.skip_connection(x) + conv(drop(norm(h), generator))


class Downsample(nn.Module):
    def __init__(self, channels, compute_dtype=torch.float32):
        super().__init__()
        self.op = Conv2d(channels, channels, 3, stride=2, padding=1,
                         compute_dtype=compute_dtype)

    def forward(self, x):
        return self.op(x)


class Upsample(nn.Module):
    """nearest-2x followed by a 3x3 conv, computed as the JAX package's
    `_PhaseUpConv` does: four 2x2 convs on the coarse grid whose taps are
    sums of the 3x3 taps, interleaved depth-to-space. Exact in real
    arithmetic; parameters are the 3x3 conv's (`conv`). The taps are
    summed in f32 and then cast to the compute dtype, the convolutions and
    the bias add run in it."""

    def __init__(self, channels, compute_dtype=torch.float32):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, padding=1)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        dt = self.compute_dtype
        x = x.to(dt)
        W = self.conv.weight  # [F, C, 3, 3], f32
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
                                 torch.stack([c10, c11], -1)], -2).to(dt)
                xp = F.pad(x, (1 - b, b, 1 - a, a))
                outs.append(F.conv2d(xp, k))
        B, Fo, H, Wd = outs[0].shape
        z = torch.stack(outs, 0).reshape(2, 2, B, Fo, H, Wd)
        z = z.permute(2, 3, 4, 0, 5, 1).reshape(B, Fo, 2 * H, 2 * Wd)
        return add_bias(z, self.conv.bias, (-1, 1, 1))


class _ConvBf16AccF32(torch.autograd.Function):
    """3x3 SAME conv on bf16 operands with an f32 output (the JAX package's
    `_conv3x3_bf16_acc_f32`, models/unet.py:418-453): the forward sums the
    exact products of the bf16 values in f32; the backward is the bf16
    conv's on the bf16-cast cotangent (torch AMP's semantics)."""

    @staticmethod
    def forward(ctx, x16, w16):
        ctx.save_for_backward(x16, w16)
        return F.conv2d(x16.float(), w16.float(), padding=1)

    @staticmethod
    def backward(ctx, g):
        x16, w16 = ctx.saved_tensors
        g16 = g.to(torch.bfloat16)
        gx = torch.nn.grad.conv2d_input(x16.shape, w16, g16, padding=1) \
            if ctx.needs_input_grad[0] else None
        gw = torch.nn.grad.conv2d_weight(x16, w16.shape, g16, padding=1) \
            if ctx.needs_input_grad[1] else None
        return gx, gw


class ConvOutBf16Acc(nn.Conv2d):
    """The UNet's 3x3 output conv under `conv_out_compute="bf16"`: bf16
    operands, f32 output, the f32 bias added after (the JAX package's
    `_ConvOutBf16Acc`, models/unet.py:456-476). Parameters as nn.Conv2d's,
    so it swaps with the f32 conv without a checkpoint change; the f32
    weight gets its gradient through the cast to bf16."""

    def __init__(self, in_channels, out_channels):
        super().__init__(in_channels, out_channels, 3, padding=1)

    def forward(self, x):
        y = _ConvBf16AccF32.apply(x.to(torch.bfloat16),
                                  self.weight.to(torch.bfloat16))
        return y + self.bias[None, :, None, None]


class UNetModel(nn.Module):
    """Denoising UNet: NCHW x [B, C, H, W], timesteps [B], context
    [B, S, D] -> [B, out_channels, H, W]. Keys mirror `unet_dict`."""

    def __init__(self, in_channels, model_channels, out_channels,
                 num_res_blocks, attention_resolutions, dropout=0.0,
                 channel_mult=(1, 2, 4, 8), num_head_channels=32,
                 transformer_depth=1, context_dim=None,
                 attn_backend="einsum", attn_softmax="fast", fused_gn=False,
                 conv_out_compute="f32", compute_dtype=torch.float32):
        super().__init__()
        mc = model_channels
        self.model_channels = mc
        emb = mc * 4
        dt = dict(compute_dtype=compute_dtype)
        self.compute_dtype = compute_dtype
        self.time_embed = nn.Sequential(Linear(mc, emb, **dt), nn.SiLU(),
                                        Linear(emb, emb, **dt))

        def res(ci, co):
            return ResBlock(ci, co, emb, dropout, fused_gn, **dt)

        def attn(ch):
            return SpatialTransformer(
                ch, ch // num_head_channels, num_head_channels,
                transformer_depth, context_dim, attn_backend, attn_softmax,
                fused_gn, **dt)

        self.input_blocks = nn.ModuleList([nn.ModuleList([
            Conv2d(in_channels, mc, 3, padding=1, **dt)])])
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
                self.input_blocks.append(
                    nn.ModuleList([Downsample(ch, **dt)]))
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
                    layers.append(Upsample(ch, **dt))
                    ds //= 2
                self.output_blocks.append(nn.ModuleList(layers))
        if conv_out_compute == "bf16":
            conv_out = ConvOutBf16Acc(mc, out_channels)
        elif conv_out_compute == "f32":  # promotes h to f32
            conv_out = Conv2d(mc, out_channels, 3, padding=1)
        else:
            raise ValueError(f"conv_out_compute {conv_out_compute!r}")
        self.out = nn.Sequential(
            GroupNorm32(mc, act="silu", fused=fused_gn), nn.Identity(),
            conv_out)

    @staticmethod
    def _run(block, h, emb, context, generator):
        for layer in block:
            if isinstance(layer, ResBlock):
                h = layer(h, emb, generator)
            elif isinstance(layer, SpatialTransformer):
                h = layer(h, context)
            else:
                h = layer(h)
        return h

    def forward(self, x, timesteps, context=None, generator=None):
        """`generator` draws the dropout masks in train mode. -> f32."""
        emb = self.time_embed(timestep_embedding(timesteps,
                                                 self.model_channels))
        hs = []
        h = x.to(self.compute_dtype)
        for block in self.input_blocks:
            h = self._run(block, h, emb, context, generator)
            hs.append(h)
        h = self._run(self.middle_block, h, emb, context, generator)
        for block in self.output_blocks:
            h = self._run(block, torch.cat([h, hs.pop()], dim=1), emb,
                          context, generator)
        return self.out(h)
