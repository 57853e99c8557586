"""The dVAE tokenizer of SLATE and STEVE (mirrors the JAX package's
models/dvae.py:25-158): a stride-4 conv encoder to `vocab_size` token
logits, a gumbel-softmax sample at the trainer's annealed temperature
(`sched["gumbel_tau"]`), and a decoder with two pixel shuffles back to
the image; the MSE `recon_loss`.

Parameter names follow the upstream model: `encoder.{0..6}` the
Conv2dBlocks (`.m` the conv, `.weight` / `.bias` the norm's affine),
`encoder.7` the 1x1 conv to the logits; `decoder.{0..4}`, the pixel
shuffle at `decoder.5`, `decoder.{6..9}`, the pixel shuffle at
`decoder.10`, `decoder.11` the 1x1 conv to RGB. NCHW inside, NHWC
images (and [B, T, H, W, 3] clips, frames folded into the batch) at the
public functions.

Each Conv2dBlock's norm is a GroupNorm of one group in f32 through
`F.group_norm`: at 128x128 a group holds 64 x 32 x 32 values (64 x 64 x
64 after the first shuffle), above the GN kernel's 32,768, and the JAX
module uses flax's GroupNorm there, not its Pallas kernel. The two 1x1
output convs compute in f32 whatever the compute dtype, as the JAX
module's do."""

import torch
import torch.nn.functional as F
from torch import nn

from .blocks import Conv2d, gumbel_softmax


def _flat(x):
    """[B, T, ...] video -> ([B*T, ...], (B, T)); an image batch passes."""
    if x.dim() == 5:
        return x.reshape(-1, *x.shape[2:]), x.shape[:2]
    return x, None


def _unflat(x, bt):
    return x if bt is None else x.reshape(*bt, *x.shape[1:])


class Conv2dBlock(nn.Module):
    """Bias-free conv (padding 0 when the kernel equals the stride, else
    k // 2) -> GroupNorm of one group in f32 -> ReLU; NCHW, the output in
    the conv's dtype."""

    def __init__(self, in_channels, out_channels, kernel_size=1, stride=1,
                 compute_dtype=torch.float32):
        super().__init__()
        pad = 0 if kernel_size == stride else kernel_size // 2
        self.m = Conv2d(in_channels, out_channels, kernel_size, stride, pad,
                        bias=False, compute_dtype=compute_dtype)
        self.weight = nn.Parameter(torch.ones(out_channels))
        self.bias = nn.Parameter(torch.zeros(out_channels))

    def forward(self, x):
        x = self.m(x)
        y = F.group_norm(x.float(), 1, self.weight, self.bias, 1e-5)
        return torch.relu(y.to(x.dtype))


class dVAE(nn.Module):
    """The discrete VAE over `vocab_size` tokens, a token per 4x4 patch
    (the upstream class's name, which configs give as `model`; the JAX
    package's `DVAE`)."""

    # the trainer's contract: nothing frozen, no EMA of a subtree
    use_ema = False
    ema_prefix = ""
    frozen_modules = ()

    def __init__(self, vocab_size, img_channels=3,
                 compute_dtype=torch.float32):
        super().__init__()
        self.vocab_size = vocab_size
        dt = dict(compute_dtype=compute_dtype)
        blk = lambda cin, cout, k=1, s=1: Conv2dBlock(cin, cout, k, s, **dt)
        self.encoder = nn.Sequential(
            blk(img_channels, 64, 4, 4), *[blk(64, 64) for _ in range(6)],
            Conv2d(64, vocab_size, 1))
        self.decoder = nn.Sequential(
            blk(vocab_size, 64), blk(64, 64, 3), blk(64, 64), blk(64, 64),
            blk(64, 256), nn.PixelShuffle(2),
            blk(64, 64, 3), blk(64, 64), blk(64, 64), blk(64, 256),
            nn.PixelShuffle(2), Conv2d(64, img_channels, 1))

    def encode_logits(self, imgs):
        """[B(, T), H, W, C] -> token logits [B(, T), h, w, vocab] (f32)."""
        x, bt = _flat(imgs)
        x = self.encoder(x.permute(0, 3, 1, 2).contiguous())
        return _unflat(x.permute(0, 2, 3, 1), bt)

    def tokenize(self, imgs, one_hot=True):
        """Hard tokens: one-hot [.., h, w, vocab] or ids [.., h, w]."""
        logits = self.encode_logits(imgs)
        idx = logits.argmax(-1)
        if one_hot:
            return F.one_hot(idx, self.vocab_size).to(logits.dtype)
        return idx

    def detokenize(self, z):
        """Token probabilities [.., h, w, vocab] -> images [.., H, W, C]."""
        x, bt = _flat(z)
        x = self.decoder(x.permute(0, 3, 1, 2).contiguous())
        return _unflat(x.permute(0, 2, 3, 1), bt)

    def forward(self, data_dict, sched=None, train=True, testing=False,
                generator=None, exp_sample=None):
        """`testing`: {"token_id"}. Else the gumbel-softmax sample of the
        log-probabilities at `sched["gumbel_tau"]` (1 without one) in
        training, their tempered softmax in eval, decoded: {"recon",
        "z_logits"}. `generator` draws the gumbel noise; tests pass its
        Exp(1) sample as `exp_sample`."""
        img = data_dict["img"]
        if testing:
            return {"token_id": self.tokenize(img, one_hot=False)}
        tau = 1.0 if not sched or "gumbel_tau" not in sched \
            else sched["gumbel_tau"]
        z_logits = torch.log_softmax(self.encode_logits(img), dim=-1)
        if train:
            z = gumbel_softmax(z_logits, tau, bool(data_dict.get(
                "hard", False)), -1, generator, exp_sample)
        else:
            z = torch.softmax(z_logits / tau, dim=-1)
        return {"recon": self.detokenize(z), "z_logits": z_logits}

    def compute_losses(self, data_dict, generator=None, train=True,
                       sched=None, exp_sample=None):
        """-> (out, {"recon_loss": the f32 MSE of the reconstruction})."""
        out = self(data_dict, sched, train, generator=generator,
                   exp_sample=exp_sample)
        loss = ((out["recon"].float() - data_dict["img"].float()) ** 2
                ).mean()
        return out, {"recon_loss": loss}
