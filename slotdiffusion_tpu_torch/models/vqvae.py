"""VQ-VAE (mirrors the JAX package's models/vqvae.py:54-382): the
taming-style Encoder/Decoder, the L2 nearest-code VectorQuantizer with
the commitment loss and the straight-through estimator, the trainable
stage-1 `VQVAE` with its losses, and the z-scaled `VQVAEWrapper` the LDM
holds frozen. NCHW inside; the public methods take and return NHWC
([B, H, W, C] or video [B, T, H, W, C], T folded into the batch).
Parameter names follow the upstream VQ-VAE (encoder.down.L.block.i, ...).

Every GroupNorm here has eps 1e-6 and runs the plain formula, as the JAX
VQ-VAE does (it never enables the fused kernel); the SiLU after it is a
separate op in the compute dtype, as there (`_silu`).

Dropout (`enc_dec_dict["dropout"]`) sits in each ResnetBlock between the
second GN+SiLU and the second conv, as in the JAX block, and runs only
when a method is called with `train=True` (the JAX `train` flag; the
frozen wrapper never passes it). Its masks come from the caller's
`torch.Generator`.

Under a bf16 `compute_dtype` (the JAX VQ-VAE's `dtype`): the blocks
compute in bf16, the attention's logits and softmax in f32; the encoder's
and the decoder's `conv_out`, `quant_conv` and `post_quant_conv` in f32
(models/vqvae.py:143, 188, 296-299 of the JAX package), so latents and
images are f32; the quantizer's distances in f32.
"""

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import lpips
from .blocks import Conv2d, GroupNorm32, dropout

_GN_EPS = 1e-6


def _gn(ch):
    return GroupNorm32(ch, eps=_GN_EPS)


def _silu(x):
    """SiLU in x's dtype. Below f32 it rounds where `jax.nn.silu` does,
    after each of its ops: exp(-x), 1 + e, 1 / (1 + e), x * s (one
    rounding, as `F.silu` takes, differs from it in ~40 % of bf16
    values)."""
    if x.dtype == torch.float32:
        return F.silu(x)
    return x * (1.0 / (1.0 + torch.exp(-x)))


class ResnetBlock(nn.Module):
    def __init__(self, in_ch, out_ch, dropout=0.0,
                 compute_dtype=torch.float32):
        super().__init__()
        dt = dict(compute_dtype=compute_dtype)
        self.dropout = dropout
        self.norm1 = _gn(in_ch)
        self.conv1 = Conv2d(in_ch, out_ch, 3, padding=1, **dt)
        self.norm2 = _gn(out_ch)
        self.conv2 = Conv2d(out_ch, out_ch, 3, padding=1, **dt)
        self.nin_shortcut = Conv2d(in_ch, out_ch, 1, **dt) \
            if in_ch != out_ch else None

    def forward(self, x, train=False, generator=None):
        h = self.conv1(_silu(self.norm1(x)))
        h = _silu(self.norm2(h))
        if train and self.dropout > 0:
            h = dropout(h, self.dropout, generator)
        h = self.conv2(h)
        if self.nin_shortcut is not None:
            x = self.nin_shortcut(x)
        return x + h


class AttnBlock(nn.Module):
    """Single-head self-attention over the pixels, standard softmax."""

    def __init__(self, ch, compute_dtype=torch.float32):
        super().__init__()
        dt = dict(compute_dtype=compute_dtype)
        self.norm = _gn(ch)
        self.q = Conv2d(ch, ch, 1, **dt)
        self.k = Conv2d(ch, ch, 1, **dt)
        self.v = Conv2d(ch, ch, 1, **dt)
        self.proj_out = Conv2d(ch, ch, 1, **dt)

    def forward(self, x):
        B, C, H, W = x.shape
        h = self.norm(x)
        flat = lambda t: t.reshape(B, C, H * W).transpose(1, 2)
        q, k, v = flat(self.q(h)), flat(self.k(h)), flat(self.v(h))
        # f32 logits and softmax, the weights in v's dtype for an
        # f32-summed value product
        w = torch.softmax((q.float() @ k.float().transpose(1, 2)) *
                          C ** -0.5, dim=-1)
        out = (w.to(v.dtype).float() @ v.float()).to(v.dtype)
        return x + self.proj_out(out.transpose(1, 2).reshape(B, C, H, W))


class _Mid(nn.Module):
    """ResnetBlock, attention (with `attn`), ResnetBlock."""

    def __init__(self, ch, dropout, attn, compute_dtype):
        super().__init__()
        self.block_1 = ResnetBlock(ch, ch, dropout, compute_dtype)
        self.attn_1 = AttnBlock(ch, compute_dtype) if attn else None
        self.block_2 = ResnetBlock(ch, ch, dropout, compute_dtype)

    def forward(self, h, train, generator):
        h = self.block_1(h, train, generator)
        if self.attn_1 is not None:
            h = self.attn_1(h)
        return self.block_2(h, train, generator)


class _Resample(nn.Module):
    def __init__(self, ch, stride, padding, compute_dtype):
        super().__init__()
        self.conv = Conv2d(ch, ch, 3, stride=stride, padding=padding,
                           compute_dtype=compute_dtype)


class _Level(nn.Module):
    """One resolution: its ResnetBlocks, each followed by an AttnBlock
    where the resolution is in `attn_resolutions`."""

    def __init__(self, blocks, attns):
        super().__init__()
        self.block = nn.ModuleList(blocks)
        self.attn = nn.ModuleList(attns)

    def forward(self, h, train, generator):
        for i, blk in enumerate(self.block):
            h = blk(h, train, generator)
            if len(self.attn):
                h = self.attn[i](h)
        return h


def _level(n_blocks, cin, cout, with_attn, dropout, compute_dtype):
    blocks = [ResnetBlock(cin if i == 0 else cout, cout, dropout,
                          compute_dtype) for i in range(n_blocks)]
    attns = [AttnBlock(cout, compute_dtype)
             for _ in range(n_blocks)] if with_attn else []
    return _Level(blocks, attns)


def _attn_of(ed):
    """Whether the layout has attention: `attn_type` "vanilla" (the
    default) or "none", as the JAX VQ-VAE reads it."""
    kind = ed.get("attn_type", "vanilla")
    if kind not in ("vanilla", "none"):
        raise ValueError(f"attn_type {kind!r}: 'vanilla' or 'none'")
    return kind == "vanilla"


class Encoder(nn.Module):
    """conv_in -> per ch_mult level: num_res_blocks ResnetBlocks (each
    with attention where the resolution is in `attn_resolutions`), a
    stride-2 conv but at the last -> mid -> GN/SiLU -> conv_out."""

    def __init__(self, ch, ch_mult, num_res_blocks, z_channels,
                 in_channels=3, resolution=128, attn_resolutions=(),
                 dropout=0.0, attn=True, compute_dtype=torch.float32):
        super().__init__()
        dt = dict(compute_dtype=compute_dtype)
        self.conv_in = Conv2d(in_channels, ch, 3, padding=1, **dt)
        self.down = nn.ModuleList()
        cin, res = ch, resolution
        for level, mult in enumerate(ch_mult):
            lvl = _level(num_res_blocks, cin, ch * mult,
                         attn and res in attn_resolutions, dropout,
                         compute_dtype)
            cin = ch * mult
            if level != len(ch_mult) - 1:
                lvl.downsample = _Resample(cin, 2, 0, compute_dtype)
                res //= 2
            self.down.append(lvl)
        self.mid = _Mid(cin, dropout, attn, compute_dtype)
        self.norm_out = _gn(cin)
        self.conv_out = Conv2d(cin, z_channels, 3, padding=1)  # f32

    def forward(self, x, train=False, generator=None):
        h = self.conv_in(x)
        for lvl in self.down:
            h = lvl(h, train, generator)
            if hasattr(lvl, "downsample"):
                # asymmetric (0, 1) pad, stride-2 conv
                h = lvl.downsample.conv(F.pad(h, (0, 1, 0, 1)))
        h = self.mid(h, train, generator)
        return self.conv_out(_silu(self.norm_out(h)))


class Decoder(nn.Module):
    """conv_in -> mid -> per level from the deepest: num_res_blocks + 1
    ResnetBlocks (attention as in the encoder), a nearest x2 upsample and
    a conv but at level 0 -> GN/SiLU -> conv_out."""

    def __init__(self, ch, ch_mult, num_res_blocks, z_channels, out_ch,
                 resolution=128, attn_resolutions=(), dropout=0.0,
                 attn=True, compute_dtype=torch.float32):
        super().__init__()
        dt = dict(compute_dtype=compute_dtype)
        cin = ch * ch_mult[-1]
        self.conv_in = Conv2d(z_channels, cin, 3, padding=1, **dt)
        self.mid = _Mid(cin, dropout, attn, compute_dtype)
        levels = [None] * len(ch_mult)
        res = resolution // 2 ** (len(ch_mult) - 1)
        for level in reversed(range(len(ch_mult))):
            lvl = _level(num_res_blocks + 1, cin, ch * ch_mult[level],
                         attn and res in attn_resolutions, dropout,
                         compute_dtype)
            cin = ch * ch_mult[level]
            if level != 0:
                lvl.upsample = _Resample(cin, 1, 1, compute_dtype)
                res *= 2
            levels[level] = lvl
        self.up = nn.ModuleList(levels)
        self.norm_out = _gn(cin)
        self.conv_out = Conv2d(cin, out_ch, 3, padding=1)  # f32

    def forward(self, z, train=False, generator=None):
        h = self.mid(self.conv_in(z), train, generator)
        for lvl in reversed(self.up):
            h = lvl(h, train, generator)
            if hasattr(lvl, "upsample"):
                h = lvl.upsample.conv(F.interpolate(h, scale_factor=2.0,
                                                    mode="nearest"))
        return self.conv_out(_silu(self.norm_out(h)))


class VectorQuantizer(nn.Module):
    """L2 nearest-code lookup as argmax(2 z e^T - |e|^2) over channel-last
    latents [..., e_dim], with the JAX quantizer's loss and gradients."""

    def __init__(self, n_e, e_dim, beta=0.25):
        super().__init__()
        self.e_dim = e_dim
        self.beta = beta
        self.embedding = nn.Embedding(n_e, e_dim)

    def nearest_indices(self, flat):
        """[P, e_dim] -> [P] indices of the nearest codes (f32 distances)."""
        e = self.embedding.weight
        scores = 2.0 * (flat.float() @ e.float().t()) - \
            (e.float() ** 2).sum(-1)[None]
        return scores.argmax(-1)

    def forward(self, z):
        """z [..., e_dim] -> (z_q [..., e_dim] in z's dtype, the commitment
        loss, indices [...]). The loss takes the legacy `beta` placement,
        mean((sg(z_q) - z)^2) + beta * mean((z_q - sg(z))^2); z_q is the
        straight-through z + sg(z_q - z), so z's gradient passes through."""
        zf = z.float()
        idx = self.nearest_indices(zf.reshape(-1, self.e_dim))
        z_q = self.embedding.weight[idx].reshape(z.shape)
        loss = torch.mean((z_q.detach() - zf) ** 2) + \
            self.beta * torch.mean((z_q - zf.detach()) ** 2)
        z_q = zf + (z_q - zf).detach()
        return z_q.to(z.dtype), loss, idx.reshape(z.shape[:-1])

    def quantize_only(self, z):
        """z [..., e_dim] -> nearest codebook entries, same shape (values
        only: the LDM's `vq_denoised` correction)."""
        idx = self.nearest_indices(z.reshape(-1, self.e_dim))
        return self.embedding.weight[idx].reshape(z.shape).to(z.dtype)

    def codebook_entry(self, indices):
        """indices [...] -> codebook entries [..., e_dim]."""
        return self.embedding.weight[indices]


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


class VQVAE(nn.Module):
    """The stage-1 VQ-VAE with the JAX model's API: `encode`,
    `encode_quantize`, `quantize_decode`, `decode`, `forward` and
    `compute_losses`, each on NHWC images or videos. `train=True` runs
    dropout with masks from `generator`. `lpips_weights` names the LPIPS
    `.npz` of the perceptual term (default: `SLOTDIFFUSION_LPIPS_WEIGHTS`,
    `ops/lpips.py`)."""

    # the Trainer's contract: nothing frozen, no EMA asked for by the
    # model; a run's `use_ema` covers every parameter, as the JAX trainer's
    # shadow does for a model without `ema_filter_prefix`
    use_ema = False
    ema_prefix = ""
    frozen_modules = ()

    def __init__(self, enc_dec_dict, vq_dict, compute_dtype=torch.float32,
                 lpips_weights=None):
        super().__init__()
        ed = enc_dec_dict
        mult = tuple(ed["ch_mult"])
        kw = dict(resolution=ed.get("resolution", 128),
                  attn_resolutions=tuple(ed.get("attn_resolutions", ())),
                  dropout=ed.get("dropout", 0.0), attn=_attn_of(ed),
                  compute_dtype=compute_dtype)
        self.encoder = Encoder(ed["ch"], mult, ed["num_res_blocks"],
                               ed["z_channels"], ed.get("in_channels", 3),
                               **kw)
        self.decoder = Decoder(ed["ch"], mult, ed["num_res_blocks"],
                               ed["z_channels"], ed["out_ch"], **kw)
        self.quantize = VectorQuantizer(vq_dict["n_embed"],
                                        vq_dict["embed_dim"],
                                        vq_dict.get("beta", 0.25))
        self.quant_conv = nn.Conv2d(ed["z_channels"], vq_dict["embed_dim"], 1)
        self.post_quant_conv = nn.Conv2d(vq_dict["embed_dim"],
                                         ed["z_channels"], 1)
        self.percept_loss_w = float(vq_dict.get("percept_loss_w", 0.0))
        self.lpips_weights = lpips_weights

    def encode(self, x, train=False, generator=None):
        """NHWC image(s) -> NHWC continuous latents (before quantizing)."""
        x, bt = _flat(x)
        h = self.quant_conv(self.encoder(_nchw(x.float()), train, generator))
        return _unflat(_nhwc(h), bt)

    def encode_quantize(self, x, train=False, generator=None):
        """-> (z_q, quant loss, token ids [..., h, w])."""
        h, bt = _flat(self.encode(x, train, generator))
        z_q, loss, idx = self.quantize(h)
        return _unflat(z_q, bt), loss, _unflat(idx, bt)

    def quantize_decode(self, h, train=False, generator=None):
        h, bt = _flat(h)
        z_q, _, _ = self.quantize(h)
        return _unflat(self._decode(z_q, train, generator), bt)

    def decode(self, z_q, train=False, generator=None):
        z_q, bt = _flat(z_q)
        return _unflat(self._decode(z_q, train, generator), bt)

    def _decode(self, z_q, train, generator):
        return _nhwc(self.decoder(self.post_quant_conv(_nchw(z_q)), train,
                                  generator))

    def forward(self, data_dict, train=False, generator=None):
        z_q, quant_loss, token_id = self.encode_quantize(
            data_dict["img"], train, generator)
        recon = self.decode(z_q, train, generator)
        return {"recon": recon, "quant_loss": quant_loss,
                "token_id": token_id, "z_q": z_q}

    def compute_losses(self, data_dict, generator=None, train=True):
        """-> (out, losses): L1 `recon_loss`, `quant_loss` and, when
        `vq_dict["percept_loss_w"]` is set and LPIPS weights are present,
        `percept_loss` (LPIPS per frame, averaged), as the JAX model's."""
        out = self(data_dict, train, generator)
        img = data_dict["img"].float()
        losses = {"recon_loss": torch.mean(torch.abs(out["recon"] - img)),
                  "quant_loss": out["quant_loss"]}
        if self.percept_loss_w and lpips.lpips_available(self.lpips_weights):
            losses["percept_loss"] = lpips.lpips_distance(
                _flat(out["recon"])[0], _flat(img)[0],
                self.lpips_weights).mean()
        return out, losses


class VQVAEWrapper(nn.Module):
    """Frozen first stage: latents are divided by `scale_factor` after
    encoding and multiplied back before quantizing or decoding."""

    def __init__(self, enc_dec_dict, vq_dict, scale_factor=1.0,
                 compute_dtype=torch.float32):
        super().__init__()
        self.vqvae = VQVAE(enc_dec_dict, vq_dict, compute_dtype)
        self.scale_factor = scale_factor

    def encode(self, x):
        """NHWC image(s) -> NHWC continuous latents."""
        return self.vqvae.encode(x) / self.scale_factor

    def quantize(self, z):
        """Snap NHWC latents to their nearest codes (scale-aware)."""
        return self.vqvae.quantize.quantize_only(z * self.scale_factor) \
            / self.scale_factor

    def decode(self, z, quantize=True):
        """NHWC latents -> NHWC images; `quantize=True` snaps first."""
        z = z * self.scale_factor
        v = self.vqvae
        return v.decode(v.quantize.quantize_only(z) if quantize else z)
