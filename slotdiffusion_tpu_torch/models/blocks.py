"""Shared building blocks, NCHW (mirrors the JAX package's models/blocks.py:
31-313).

Compute dtype, flax's way (`use_bf16`): parameters stay f32 under the
same names, and each layer casts its input and its weights to its
`compute_dtype` at use, as `nn.Dense(dtype=...)` / `nn.Conv(dtype=...)`
do, and rounds where they do: the product to the compute dtype, then the
bias added in it (`add_bias`); norms take their statistics and affine in
f32 and round once to the compute dtype (LayerNorm) or to the input's
dtype (GroupNorm). With `compute_dtype=torch.float32` (the default) every
cast is a no-op and the layers are torch's own.
"""

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.fused_norm import fused_group_norm, group_norm_reference


def add_bias(y, bias, shape=(-1,)):
    """y + bias in y's dtype. Under bf16 that is flax's rounding point:
    `dot_general` / `conv` round their f32 sums to bf16, then the bias is
    added in bf16 (a second rounding; a bias fused into the product rounds
    once, and puts an independent bf16 error on most outputs of every
    layer). None adds nothing."""
    return y if bias is None else y + bias.to(y.dtype).reshape(shape)


def dropout(x, p, generator):
    """Inverted dropout at rate `p` with its mask drawn from `generator`:
    a kept value is x / (1 - p), in x's dtype (flax's `nn.Dropout`)."""
    if generator is None:
        raise ValueError("dropout in train mode needs a torch.Generator")
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= p
    return x * keep / (1.0 - p)


def linear(x, weight, bias, compute_dtype):
    """x @ weight^T + bias in `compute_dtype` (flax `nn.Dense(dtype)`): the
    input and the f32 weight cast at use, the bias added after the
    product's rounding (`add_bias`); in f32, torch's own `F.linear`."""
    if compute_dtype == torch.float32:
        return F.linear(x.float(), weight, bias)
    return add_bias(F.linear(x.to(compute_dtype), weight.to(compute_dtype)),
                    bias)


class Linear(nn.Linear):
    """`nn.Linear` computing in `compute_dtype` (`linear`)."""

    def __init__(self, in_features, out_features, bias=True,
                 compute_dtype=torch.float32):
        super().__init__(in_features, out_features, bias)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        return linear(x, self.weight, self.bias, self.compute_dtype)


class Conv2d(nn.Conv2d):
    """`nn.Conv2d` computing in `compute_dtype` (flax `nn.Conv(dtype)`):
    f32 parameters, the input and kernel cast at use, the bias added after
    the convolution's rounding."""

    def __init__(self, *args, compute_dtype=torch.float32, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        dt = self.compute_dtype
        if dt == torch.float32:
            return super().forward(x.float())
        return add_bias(self._conv_forward(x.to(dt), self.weight.to(dt),
                                           None), self.bias, (-1, 1, 1))


class ConvTranspose2d(nn.ConvTranspose2d):
    """`nn.ConvTranspose2d` computing in `compute_dtype`, as `Conv2d`."""

    def __init__(self, *args, compute_dtype=torch.float32, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        dt = self.compute_dtype
        if dt == torch.float32:
            return super().forward(x.float())
        y = F.conv_transpose2d(x.to(dt), self.weight.to(dt), None,
                               self.stride, self.padding,
                               self.output_padding)
        return add_bias(y, self.bias, (-1, 1, 1))


class LayerNorm(nn.LayerNorm):
    """`nn.LayerNorm` as flax's `nn.LayerNorm(dtype)`: statistics and
    affine in f32, one rounding to `compute_dtype`."""

    def __init__(self, normalized_shape, eps=1e-5,
                 compute_dtype=torch.float32):
        super().__init__(normalized_shape, eps=eps)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape, self.weight,
                            self.bias, self.eps).to(self.compute_dtype)


class GroupNorm32(nn.GroupNorm):
    """GroupNorm with f32 statistics and an optional fused SiLU; the output
    has the input's dtype (bf16 under `use_bf16`).

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
    feature map (parameters: `dense`), in `compute_dtype`."""

    def __init__(self, hidden_size, compute_dtype=torch.float32):
        super().__init__()
        self.dense = Linear(4, hidden_size, compute_dtype=compute_dtype)

    def forward(self, inputs):
        return inputs + self.dense(build_grid(inputs.shape[1:3],
                                              inputs.device))


class MLP(nn.Sequential):
    """Dense layers with an activation between them, optional pre-LN, in
    `compute_dtype`."""

    def __init__(self, in_dim, hidden_dims, out_dim, act=nn.ReLU,
                 pre_norm=False, compute_dtype=torch.float32):
        dt = dict(compute_dtype=compute_dtype)
        layers = [LayerNorm(in_dim, **dt)] if pre_norm else []
        for d in hidden_dims:
            layers += [Linear(in_dim, d, **dt), act()]
            in_dim = d
        layers.append(Linear(in_dim, out_dim, **dt))
        super().__init__(*layers)


class ChannelLayerNorm(LayerNorm):
    """LayerNorm over the channels of an NCHW map (flax's LayerNorm on the
    last axis of NHWC), eps 1e-5."""

    def forward(self, x):
        return super().forward(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


def get_norm(norm, channels, compute_dtype=torch.float32):
    """A norm name -> its module over `channels` (None for ""), as the JAX
    package's `get_norm`: GroupNorm32 with 32 groups or LayerNorm."""
    if not norm:
        return None
    if norm in ("gn", "group_norm", "groupnorm"):
        return GroupNorm32(channels)
    if norm in ("ln", "layer_norm", "layernorm"):
        return ChannelLayerNorm(channels, eps=1e-5,
                                compute_dtype=compute_dtype)
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
    """Conv2d -> norm -> activation with flax's "SAME" padding, NCHW, in
    `compute_dtype` (the
    JAX package's ConvNormAct). Modules `0` (conv), `1` (norm or
    Identity), `2` (activation or Identity), as upstream's
    `conv_norm_act` names them."""

    def __init__(self, in_channels, out_channels, kernel_size=3, stride=1,
                 norm="", act="relu", compute_dtype=torch.float32):
        super().__init__(
            Conv2d(in_channels, out_channels, kernel_size, stride,
                   compute_dtype=compute_dtype),
            get_norm(norm, out_channels, compute_dtype) or nn.Identity(),
            get_act(act) or nn.Identity())

    def forward(self, x):
        conv = self[0]
        (t, b), (l, r) = (same_padding(n, k, s) for n, k, s in zip(
            x.shape[2:], conv.kernel_size, conv.stride))
        return self[2](self[1](conv(F.pad(x, (l, r, t, b)))))


class DeconvNormAct(nn.Sequential):
    """ConvTranspose2d -> norm -> activation, NCHW, in `compute_dtype`
    (the JAX package's DeconvNormAct): `ConvTranspose2d(k, s,
    padding=k // 2, output_padding=s - 1)`, so the output is exactly `s`
    times the input, with the JAX module's asymmetric crop: a transposed
    convolution padded (k - 1 - k // 2) before and that plus s - 1 after
    (flax's "SAME" split would shift the pixels by one at stride 2).
    Modules `0` (deconv), `1` (norm or Identity), `2` (activation or
    Identity), as upstream's `deconv_norm_act` names them."""

    def __init__(self, in_channels, out_channels, kernel_size=5, stride=2,
                 norm="", act="relu", compute_dtype=torch.float32):
        super().__init__(
            ConvTranspose2d(in_channels, out_channels, kernel_size, stride,
                            padding=kernel_size // 2,
                            output_padding=stride - 1,
                            compute_dtype=compute_dtype),
            get_norm(norm, out_channels, compute_dtype) or nn.Identity(),
            get_act(act) or nn.Identity())


def cosine_anneal(step, start_value, final_value, start_step, final_step):
    """Cosine annealing from `start_value` at `start_step` to `final_value`
    at `final_step` and after (the JAX package's models/blocks.py:315-327;
    the dVAE's gumbel temperature). A Python float, computed in f32 as the
    JAX function computes it."""
    if final_step <= start_step:
        return final_value
    f32 = lambda v: torch.tensor(v, dtype=torch.float32)
    progress = (f32(step - start_step) / f32(final_step - start_step)
                ).clamp(0.0, 1.0)
    return (f32(0.5 * (start_value + final_value)) +
            f32(0.5 * (start_value - final_value)) *
            torch.cos(f32(math.pi) * progress)).item()


def gumbel_softmax(logits, tau=1.0, hard=False, dim=-1, generator=None,
                   exp_sample=None):
    """Gumbel-softmax (the JAX package's models/blocks.py:339-355): gumbels
    -log(max(E, tiny)) of an Exp(1) sample E, drawn from `generator` on
    the logits' device or passed in (`exp_sample`, e.g. the JAX draw a
    test shares); `hard` gives the one-hot of the argmax in the forward
    pass with the soft sample's gradient (straight through)."""
    if exp_sample is None:
        if generator is None:
            raise ValueError("a gumbel sample needs a torch.Generator")
        exp_sample = torch.empty_like(logits).exponential_(
            generator=generator)
    if exp_sample.shape != logits.shape:
        raise ValueError(f"an Exp(1) sample of {tuple(exp_sample.shape)} "
                         f"for logits of {tuple(logits.shape)}")
    tiny = torch.finfo(logits.dtype).tiny
    gumbels = -torch.log(torch.clamp_min(exp_sample.to(logits.dtype), tiny))
    y = torch.softmax((logits + gumbels) / tau, dim=dim)
    if hard:
        y_hard = F.one_hot(y.argmax(dim), y.shape[dim]).to(y.dtype)
        y_hard = y_hard.movedim(-1, dim)
        y = y + (y_hard - y).detach()
    return y
