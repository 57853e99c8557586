"""VQ-VAE first stage of the LDM (mirrors the JAX package's models/vqvae.py:
54-247, 336-382): taming-style Encoder/Decoder, the L2 nearest-code
VectorQuantizer and the z-scaled VQVAEWrapper. NCHW inside; the public
methods take and return NHWC ([B, H, W, C] or [B, T, H, W, C]).
Parameter names follow the upstream VQ-VAE (encoder.down.L.block.i, ...).

Every GroupNorm here has eps 1e-6 and runs the plain formula, as the JAX
VQ-VAE does (it never enables the fused kernel).
"""

import torch
import torch.nn.functional as F
from torch import nn

from .blocks import GroupNorm32

_GN_EPS = 1e-6


def _gn(ch, act=None):
    return GroupNorm32(ch, eps=_GN_EPS, act=act)


class ResnetBlock(nn.Module):
    def __init__(self, in_ch, out_ch):
        super().__init__()
        self.norm1 = _gn(in_ch, "silu")
        self.conv1 = nn.Conv2d(in_ch, out_ch, 3, padding=1)
        self.norm2 = _gn(out_ch, "silu")
        self.conv2 = nn.Conv2d(out_ch, out_ch, 3, padding=1)
        self.nin_shortcut = nn.Conv2d(in_ch, out_ch, 1) \
            if in_ch != out_ch else None

    def forward(self, x):
        h = self.conv2(self.norm2(self.conv1(self.norm1(x))))
        if self.nin_shortcut is not None:
            x = self.nin_shortcut(x)
        return x + h


class AttnBlock(nn.Module):
    """Single-head self-attention over the pixels, standard softmax."""

    def __init__(self, ch):
        super().__init__()
        self.norm = _gn(ch)
        self.q = nn.Conv2d(ch, ch, 1)
        self.k = nn.Conv2d(ch, ch, 1)
        self.v = nn.Conv2d(ch, ch, 1)
        self.proj_out = nn.Conv2d(ch, ch, 1)

    def forward(self, x):
        B, C, H, W = x.shape
        h = self.norm(x)
        flat = lambda t: t.reshape(B, C, H * W).transpose(1, 2)
        q, k, v = flat(self.q(h)), flat(self.k(h)), flat(self.v(h))
        w = torch.softmax((q @ k.transpose(1, 2)) * C ** -0.5, dim=-1)
        out = (w @ v).transpose(1, 2).reshape(B, C, H, W)
        return x + self.proj_out(out)


class _Mid(nn.Module):
    def __init__(self, ch):
        super().__init__()
        self.block_1 = ResnetBlock(ch, ch)
        self.attn_1 = AttnBlock(ch)
        self.block_2 = ResnetBlock(ch, ch)

    def forward(self, h):
        return self.block_2(self.attn_1(self.block_1(h)))


class _Resample(nn.Module):
    def __init__(self, ch, stride, padding):
        super().__init__()
        self.conv = nn.Conv2d(ch, ch, 3, stride=stride, padding=padding)


class _Level(nn.Module):
    def __init__(self, blocks):
        super().__init__()
        self.block = nn.ModuleList(blocks)
        self.attn = nn.ModuleList()  # attn_resolutions is empty upstream


def _check_dict(ed):
    if ed.get("attn_resolutions") or ed.get("attn_type", "vanilla") != \
            "vanilla" or ed.get("double_z", False):
        raise ValueError("only the flagship VQ-VAE layout is ported")


class Encoder(nn.Module):
    def __init__(self, ch, ch_mult, num_res_blocks, z_channels,
                 in_channels=3):
        super().__init__()
        self.conv_in = nn.Conv2d(in_channels, ch, 3, padding=1)
        self.down = nn.ModuleList()
        cin = ch
        for level, mult in enumerate(ch_mult):
            blocks = []
            for _ in range(num_res_blocks):
                blocks.append(ResnetBlock(cin, ch * mult))
                cin = ch * mult
            lvl = _Level(blocks)
            if level != len(ch_mult) - 1:
                lvl.downsample = _Resample(cin, stride=2, padding=0)
            self.down.append(lvl)
        self.mid = _Mid(cin)
        self.norm_out = _gn(cin, "silu")
        self.conv_out = nn.Conv2d(cin, z_channels, 3, padding=1)

    def forward(self, x):
        h = self.conv_in(x)
        for lvl in self.down:
            for blk in lvl.block:
                h = blk(h)
            if hasattr(lvl, "downsample"):
                # asymmetric (0, 1) pad, stride-2 conv
                h = lvl.downsample.conv(F.pad(h, (0, 1, 0, 1)))
        return self.conv_out(self.norm_out(self.mid(h)))


class Decoder(nn.Module):
    def __init__(self, ch, ch_mult, num_res_blocks, z_channels, out_ch):
        super().__init__()
        cin = ch * ch_mult[-1]
        self.conv_in = nn.Conv2d(z_channels, cin, 3, padding=1)
        self.mid = _Mid(cin)
        levels = [None] * len(ch_mult)
        for level in reversed(range(len(ch_mult))):
            blocks = []
            for _ in range(num_res_blocks + 1):
                blocks.append(ResnetBlock(cin, ch * ch_mult[level]))
                cin = ch * ch_mult[level]
            lvl = _Level(blocks)
            if level != 0:
                lvl.upsample = _Resample(cin, stride=1, padding=1)
            levels[level] = lvl
        self.up = nn.ModuleList(levels)
        self.norm_out = _gn(cin, "silu")
        self.conv_out = nn.Conv2d(cin, out_ch, 3, padding=1)

    def forward(self, z):
        h = self.mid(self.conv_in(z))
        for lvl in reversed(self.up):
            for blk in lvl.block:
                h = blk(h)
            if hasattr(lvl, "upsample"):
                h = lvl.upsample.conv(F.interpolate(h, scale_factor=2.0,
                                                    mode="nearest"))
        return self.conv_out(self.norm_out(h))


class VectorQuantizer(nn.Module):
    """L2 nearest-code lookup as argmax(2 z e^T - |e|^2)."""

    def __init__(self, n_e, e_dim):
        super().__init__()
        self.e_dim = e_dim
        self.embedding = nn.Embedding(n_e, e_dim)

    def quantize_only(self, z):
        """z [..., e_dim] -> nearest codebook entries, same shape."""
        e = self.embedding.weight
        flat = z.reshape(-1, self.e_dim).float()
        scores = 2.0 * (flat @ e.t()) - (e.float() ** 2).sum(-1)[None]
        return e[scores.argmax(-1)].reshape(z.shape).to(z.dtype)


class VQVAE(nn.Module):
    def __init__(self, enc_dec_dict, vq_dict):
        super().__init__()
        ed = enc_dec_dict
        _check_dict(ed)
        mult = tuple(ed["ch_mult"])
        self.encoder = Encoder(ed["ch"], mult, ed["num_res_blocks"],
                               ed["z_channels"], ed.get("in_channels", 3))
        self.decoder = Decoder(ed["ch"], mult, ed["num_res_blocks"],
                               ed["z_channels"], ed["out_ch"])
        self.quantize = VectorQuantizer(vq_dict["n_embed"],
                                        vq_dict["embed_dim"])
        self.quant_conv = nn.Conv2d(ed["z_channels"], vq_dict["embed_dim"], 1)
        self.post_quant_conv = nn.Conv2d(vq_dict["embed_dim"],
                                         ed["z_channels"], 1)


def _flat(x):
    """[B, T, H, W, C] -> ([B*T, H, W, C], (B, T)); 4-D passes through."""
    if x.dim() == 5:
        return x.reshape(-1, *x.shape[2:]), x.shape[:2]
    return x, None


def _unflat(x, bt):
    return x if bt is None else x.reshape(*bt, *x.shape[1:])


def _nchw(x):
    return x.permute(0, 3, 1, 2).contiguous()


def _nhwc(x):
    return x.permute(0, 2, 3, 1).contiguous()


class VQVAEWrapper(nn.Module):
    """Frozen first stage: latents are divided by `scale_factor` after
    encoding and multiplied back before quantizing or decoding."""

    def __init__(self, enc_dec_dict, vq_dict, scale_factor=1.0):
        super().__init__()
        self.vqvae = VQVAE(enc_dec_dict, vq_dict)
        self.scale_factor = scale_factor

    def encode(self, x):
        """NHWC image(s) -> NHWC continuous latents."""
        x, bt = _flat(x)
        v = self.vqvae
        h = _nhwc(v.quant_conv(v.encoder(_nchw(x.float()))))
        return _unflat(h / self.scale_factor, bt)

    def quantize(self, z):
        """Snap NHWC latents to their nearest codes (scale-aware)."""
        return self.vqvae.quantize.quantize_only(z * self.scale_factor) \
            / self.scale_factor

    def decode(self, z, quantize=True):
        """NHWC latents -> NHWC images; `quantize=True` snaps first."""
        z, bt = _flat(z * self.scale_factor)
        v = self.vqvae
        if quantize:
            z = v.quantize.quantize_only(z)
        x = v.decoder(v.post_quant_conv(_nchw(z)))
        return _unflat(_nhwc(x), bt)
