"""Modules of the port, NCHW inside; public functions keep the JAX
package's layouts (NHWC images, [B, T, H, W, 3] video)."""

import math

import torch


def compute_dtype_of(params):
    """bf16 under `params.use_bf16`, else f32 (the JAX `_dtype_of`,
    models/__init__.py:38-39 of the JAX package)."""
    return torch.bfloat16 if params.use_bf16 else torch.float32


def build_model(params, device="cuda"):
    """Instantiate the model named by `params.model` (SAViDiffusion is the
    only model of this slice) on `device`, in eval mode. Parameters are f32
    whatever the compute dtype (`compute_dtype_of`), so a bf16 model loads
    an f32 checkpoint and trains f32 master weights."""
    from .slot_diffusion import SAViDiffusion
    if params.model != "SAViDiffusion":
        raise ValueError(f"model {params.model!r} is not ported yet")
    model = SAViDiffusion(
        resolution=tuple(params.resolution), slot_dict=params.slot_dict,
        enc_dict=params.enc_dict, dec_dict=params.dec_dict,
        pred_dict=params.pred_dict, compute_dtype=compute_dtype_of(params))
    return model.to(device).eval()


@torch.no_grad()
def init_random_(model, generator):
    """Smoke filler, not a training start: fill every parameter from
    `generator` (seeded by the caller) with norm scales near 1, small
    biases, and matrices and kernels ~ N(0, 1/fan_in). Zero-initialized
    output layers get random values too, so a random model exercises every
    layer and every parameter gets a gradient at the first step
    (`chip_smoke.py`, tests). Training starts from `init_reference_`."""
    for name, p in model.named_parameters():
        noise = torch.randn(p.shape, generator=generator,
                            dtype=torch.float32).to(p.device)
        if p.dim() == 1:
            is_scale = name.endswith("weight")
            p.copy_((1.0 if is_scale else 0.0) + 0.02 * noise)
        elif name.endswith("embedding.weight"):
            p.copy_(noise)
        else:
            fan_in = p[0].numel() if p.dim() > 1 else p.shape[-1]
            p.copy_(noise * fan_in ** -0.5)
    return model


# The flax initializers the JAX package's SAViDiffusion uses, as
# (scale, mode, distribution) of `variance_scaling`
LECUN_NORMAL = (1.0, "fan_in", "truncated_normal")  # flax's default kernels
RESNET_CONV = (2.0, "fan_out", "truncated_normal")  # models/resnet.py:21
CONV_BLOCK = (1.0 / 3.0, "fan_in", "uniform")       # models/blocks.py:26


def _fans(shape):
    """(fan_in, fan_out) of a port weight counted in the JAX layout: a
    linear [out, in] is flax's [in, out], a conv [F, C, kh, kw] is flax's
    [kh, kw, C, F], so fan_in = C*kh*kw and fan_out = F*kh*kw."""
    receptive = math.prod(shape[2:])
    return shape[1] * receptive, shape[0] * receptive


def _variance_scaling(shape, init, generator):
    """flax's `variance_scaling(scale, mode, distribution)`: variance
    scale / fan; the truncated normal is cut at +-2 and rescaled by
    1 / 0.87962566 (its std on [-2, 2]) so its std is sqrt(scale / fan)."""
    scale, mode, distribution = init
    fan_in, fan_out = _fans(shape)
    std = math.sqrt(scale / (fan_in if mode == "fan_in" else fan_out))
    if distribution == "uniform":
        u = torch.rand(shape, generator=generator, dtype=torch.float64)
        return (2 * u - 1) * math.sqrt(3.0) * std
    if distribution != "truncated_normal":
        raise ValueError(f"unsupported distribution {distribution}")
    # inverse CDF of the standard normal on [Phi(-2), Phi(2)]
    lo, hi = (0.5 * (1 + math.erf(b / math.sqrt(2))) for b in (-2.0, 2.0))
    u = lo + (hi - lo) * torch.rand(shape, generator=generator,
                                    dtype=torch.float64)
    z = math.sqrt(2.0) * torch.erfinv(2 * u - 1)
    return z * std / 0.87962566103423978


def _orthogonal_blocks(shape, generator):
    """[n*D, D]: n blocks, each a Haar-orthogonal [D, D] (flax's
    `orthogonal()`: Q of a Gaussian's QR, columns signed by diag(R))."""
    D = shape[1]
    blocks = []
    for _ in range(shape[0] // D):
        a = torch.randn(D, D, generator=generator, dtype=torch.float64)
        q, r = torch.linalg.qr(a)
        blocks.append((q * torch.sign(torch.diagonal(r))).T)
    return torch.cat(blocks)


@torch.no_grad()
def init_reference_(model, generator):
    """The JAX model's own init (`model.init` of the JAX package), from
    `generator` (a seeded CPU `torch.Generator`): a training run starts
    here (`scripts/train_torch.py`). Per parameter, as the JAX module it
    mirrors draws it:
    - zeros: every bias, each UNet ResBlock's second conv, each
      SpatialTransformer's proj_out and the UNet's output conv
      (models/unet.py:210, 299, 617);
    - ones: norm scales (models/blocks.py:43-45, flax LayerNorm/GroupNorm);
    - N(0, 1): `init_latents` (models/savi.py:76-78);
    - U(-1/n, 1/n): the VQ codebook of n entries (models/vqvae.py:206);
    - per-gate orthogonal [D, D] blocks: the GRU's recurrent weight
      (models/slot_attention.py:55-61);
    - `RESNET_CONV` for the GN-ResNet's convs, `CONV_BLOCK` for any other
      conv of the SA encoder (the plain-CNN branch);
    - lecun_normal (`LECUN_NORMAL`) for every other matrix and kernel:
      dense layers, attention projections, the other convs.
    The values are drawn in float64 on the CPU and copied in."""
    from .resnet import ResNet
    from .unet import ResBlock, SpatialTransformer, UNetModel
    from .vqvae import VectorQuantizer
    zero = {id(m.out_layers[-1].weight) for m in model.modules()
            if isinstance(m, ResBlock)}
    zero |= {id(m.proj_out.weight) for m in model.modules()
             if isinstance(m, SpatialTransformer)}
    zero |= {id(m.out[-1].weight) for m in model.modules()
             if isinstance(m, UNetModel)}
    codebooks = {id(m.embedding.weight) for m in model.modules()
                 if isinstance(m, VectorQuantizer)}
    resnet = {id(p) for m in model.modules() if isinstance(m, ResNet)
              for p in m.parameters() if p.dim() == 4}
    enc_convs = {id(p) for p in model.savi.encoder.parameters()
                 if p.dim() == 4}
    for name, p in model.named_parameters():
        if id(p) in zero:
            v = torch.zeros(p.shape)
        elif p.dim() == 1:  # norm scales are "weight", the rest biases
            v = torch.ones(p.shape) if name.endswith("weight") \
                else torch.zeros(p.shape)
        elif name.endswith("init_latents"):
            v = torch.randn(p.shape, generator=generator, dtype=torch.float64)
        elif id(p) in codebooks:
            n = p.shape[0]
            v = (2 * torch.rand(p.shape, generator=generator,
                                dtype=torch.float64) - 1) / n
        elif name.endswith("gru.weight_hh"):
            v = _orthogonal_blocks(p.shape, generator)
        elif id(p) in resnet:
            v = _variance_scaling(p.shape, RESNET_CONV, generator)
        elif id(p) in enc_convs:
            v = _variance_scaling(p.shape, CONV_BLOCK, generator)
        else:
            v = _variance_scaling(p.shape, LECUN_NORMAL, generator)
        p.copy_(v.to(p.dtype))
    return model
