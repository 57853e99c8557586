"""Modules of the port, NCHW inside; public functions keep the JAX
package's layouts (NHWC images, [B, T, H, W, 3] video)."""

import math

import torch


def compute_dtype_of(params):
    """bf16 under `params.use_bf16`, else f32 (the JAX `_dtype_of`,
    models/__init__.py:38-39 of the JAX package)."""
    return torch.bfloat16 if params.use_bf16 else torch.float32


def is_video(name):
    """Whether the model `name` (a config's `model`, or the class name of
    what `build_model` made of it) takes clips [B, T, H, W, 3] rather than
    images [B, H, W, 3] (as the JAX scripts/export_model.py:62-66 tells
    them apart)."""
    return name.startswith(("SAVi", "STEVE"))


def build_model(params, device="cuda"):
    """Instantiate the model named by `params.model` (SAViDiffusion,
    SADiffusion, SA, SAVi, STEVE, SLATE, the video-prediction stage's
    SlotFormer and LDMSlotFormer, the Physion readout PhysionReadout,
    the stage-1 VQVAE from
    `params.enc_dec_dict` and `params.vq_dict`, or the stage-1 dVAE
    ("dVAE" or "DVAE") of `params.dvae_dict["vocab_size"]`, else
    `params.vocab_size`) on `device`, in eval mode. Parameters are f32
    whatever the compute dtype (`compute_dtype_of`), so a bf16 model
    loads an f32 checkpoint and trains f32 master weights. A VQVAE reads
    its LPIPS weights from `params.lpips_weights` when the config sets it
    (else from `SLOTDIFFUSION_LPIPS_WEIGHTS`, ops/lpips.py)."""
    dtype = compute_dtype_of(params)
    if params.model == "VQVAE":
        from .vqvae import VQVAE
        model = VQVAE(params.enc_dec_dict, params.vq_dict, dtype,
                      getattr(params, "lpips_weights", None))
    elif params.model == "SAViDiffusion":
        from .slot_diffusion import SAViDiffusion
        model = SAViDiffusion(
            resolution=tuple(params.resolution), slot_dict=params.slot_dict,
            enc_dict=params.enc_dict, dec_dict=params.dec_dict,
            pred_dict=params.pred_dict, compute_dtype=dtype)
    elif params.model == "SADiffusion":
        from .slot_diffusion import SADiffusion
        model = SADiffusion(
            resolution=tuple(params.resolution), slot_dict=params.slot_dict,
            enc_dict=params.enc_dict, dec_dict=params.dec_dict,
            compute_dtype=dtype)
    elif params.model == "SA":
        from .sa import SA
        model = SA(resolution=tuple(params.resolution),
                   slot_dict=params.slot_dict, enc_dict=params.enc_dict,
                   dec_dict=params.dec_dict, compute_dtype=dtype)
    elif params.model == "SAVi":
        from .savi import SAVi
        model = SAVi(tuple(params.resolution), params.slot_dict,
                     params.enc_dict, params.pred_dict,
                     dec_dict=params.dec_dict, compute_dtype=dtype)
    elif params.model == "STEVE":
        from .slate import STEVE
        model = STEVE(tuple(params.resolution), params.slot_dict,
                      params.enc_dict, params.dec_dict, params.dvae_dict,
                      params.pred_dict, getattr(params, "loss_dict", None),
                      compute_dtype=dtype)
    elif params.model == "SLATE":
        from .slate import SLATE
        model = SLATE(tuple(params.resolution), params.slot_dict,
                      params.enc_dict, params.dec_dict, params.dvae_dict,
                      getattr(params, "loss_dict", None),
                      compute_dtype=dtype)
    elif params.model in ("dVAE", "DVAE"):
        from .dvae import dVAE
        dvae_dict = getattr(params, "dvae_dict", None)
        model = dVAE(dvae_dict["vocab_size"] if dvae_dict else
                     params.vocab_size, compute_dtype=dtype)
    elif params.model in ("SlotFormer", "LDMSlotFormer"):
        from . import slotformer
        model = getattr(slotformer, params.model)(
            tuple(params.resolution), params.slot_dict,
            getattr(params, "dec_dict", None) or {}, params.rollout_dict,
            params.loss_dict, compute_dtype=dtype)
    elif params.model == "PhysionReadout":
        from .readout import PhysionReadout
        model = PhysionReadout(params.readout_dict, compute_dtype=dtype)
    else:
        raise ValueError(f"model {params.model!r} is not ported yet")
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


# The flax initializers the JAX package's models use, as
# (scale, mode, distribution) of `variance_scaling`
LECUN_NORMAL = (1.0, "fan_in", "truncated_normal")  # flax's default kernels
RESNET_CONV = (2.0, "fan_out", "truncated_normal")  # models/resnet.py:21
CONV_BLOCK = (1.0 / 3.0, "fan_in", "uniform")       # models/blocks.py:26


def _fans(shape, transposed=False):
    """(fan_in, fan_out) of a port weight counted in the JAX layout: a
    linear [out, in] is flax's [in, out], a conv [F, C, kh, kw] is flax's
    [kh, kw, C, F], so fan_in = C*kh*kw and fan_out = F*kh*kw; a
    transposed conv's [C, F, kh, kw] (`transposed`) is flax's
    ConvTranspose [kh, kw, C, F]."""
    receptive = math.prod(shape[2:])
    fan_in, fan_out = shape[1] * receptive, shape[0] * receptive
    return (fan_out, fan_in) if transposed else (fan_in, fan_out)


def _variance_scaling(shape, init, generator, transposed=False):
    """flax's `variance_scaling(scale, mode, distribution)`: variance
    scale / fan; the truncated normal is cut at +-2 and rescaled by
    1 / 0.87962566 (its std on [-2, 2]) so its std is sqrt(scale / fan)."""
    scale, mode, distribution = init
    fan_in, fan_out = _fans(shape, transposed)
    fan = {"fan_in": fan_in, "fan_out": fan_out,
           "fan_avg": (fan_in + fan_out) / 2}[mode]
    std = math.sqrt(scale / fan)
    if distribution == "uniform":
        u = torch.rand(shape, generator=generator, dtype=torch.float64)
        return (2 * u - 1) * math.sqrt(3.0) * std
    if distribution != "truncated_normal":
        raise ValueError(f"unsupported distribution {distribution}")
    return _truncated_normal(shape, generator) * std / 0.87962566103423978


def _truncated_normal(shape, generator):
    """The standard normal cut at +-2 (not rescaled: flax's
    `truncated_normal(1.0)`), by the inverse CDF on [Phi(-2), Phi(2)]."""
    lo, hi = (0.5 * (1 + math.erf(b / math.sqrt(2))) for b in (-2.0, 2.0))
    u = lo + (hi - lo) * torch.rand(shape, generator=generator,
                                    dtype=torch.float64)
    return math.sqrt(2.0) * torch.erfinv(2 * u - 1)


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
    - zeros: every bias, a rollouter's learnable PEs (`enc_t_pe`,
      `enc_slots_pe`, models/slotformer.py:129-144), each UNet
      ResBlock's second conv, each
      SpatialTransformer's proj_out and the UNet's output conv
      (models/unet.py:210, 299, 617);
    - ones: norm scales (models/blocks.py:43-45, flax LayerNorm/GroupNorm);
    - N(0, 1): `init_latents` (models/savi.py:76-78, models/sa.py:153,
      models/slot_diffusion.py:88);
    - the DINO ViT (models/dino.py:75-78): zeros for `cls_token`,
      N(0, 0.02^2) for `position_embeddings`, lecun_normal for its patch
      conv and every dense layer (of q/k/v [in, heads, hd] and the output
      [heads, hd, out] the fans of the flattened matrix);
    - U(-1/n, 1/n): the VQ codebook of n entries (models/vqvae.py:206),
      in SAViDiffusion's frozen VQ-VAE and in a bare stage-1 VQVAE;
    - per-gate orthogonal [D, D] blocks: the GRU's recurrent weight
      (models/slot_attention.py:55-61);
    - `RESNET_CONV` for the GN-ResNet's convs, `CONV_BLOCK` for any other
      conv of the SA encoder (the plain-CNN branch) and for the spatial
      broadcast decoder's transposed convs (models/blocks.py:225, fans of
      flax's [kh, kw, C, F] layout);
    - per-gate orthogonal [H, H] blocks: an LSTM's recurrent weight
      (flax's `OptimizedLSTMCell`, models/predictor.py:98-103);
    - the AR token decoder (models/ar_decoder.py:40-50, 105-112,
      160-166): `variance_scaling(1, fan_avg, uniform)` for the q/k/v
      projections, `(gain^2, fan_avg, uniform)` with gain = (3 x
      layers)^-1/2 for each `proj_o` and the FFN's second layer,
      `(2, fan_in, truncated_normal)` for its first, N(0, 0.02^2) for
      `tok_emb`, the standard normal cut at +-2 for `pos_emb`;
    - lecun_normal (`LECUN_NORMAL`) for every other matrix and kernel:
      dense layers, attention projections, the LSTM's input weights, the
      other convs (every conv of a VQ-VAE and of a dVAE).
    The values are drawn in float64 on the CPU and copied in."""
    from .ar_decoder import ARDecoderBlock, ARMultiHeadAttention
    from .blocks import ConvTranspose2d
    from .dino import DINOEncoder
    from .resnet import ResNet
    from .sa import SAEncoder
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
    dino = {id(p) for m in model.modules() if isinstance(m, DINOEncoder)
            for p in m.parameters()}
    enc_convs = {id(p) for m in model.modules() if isinstance(m, SAEncoder)
                 for p in m.parameters() if p.dim() == 4} - dino
    deconvs = {id(m.weight) for m in model.modules()
               if isinstance(m, ConvTranspose2d)}
    ar = {}
    for m in model.modules():
        if isinstance(m, ARMultiHeadAttention):
            ar.update({id(getattr(m, k).weight): (1.0, "fan_avg", "uniform")
                       for k in ("proj_q", "proj_k", "proj_v")})
            ar[id(m.proj_o.weight)] = (m.gain ** 2, "fan_avg", "uniform")
        if isinstance(m, ARDecoderBlock):
            ar[id(m.ffn[0].weight)] = (2.0, "fan_in", "truncated_normal")
            ar[id(m.ffn[2].weight)] = (m.self_attn.gain ** 2, "fan_avg",
                                       "uniform")
    for name, p in model.named_parameters():
        if id(p) in zero or name.endswith(("enc_t_pe", "enc_slots_pe")):
            v = torch.zeros(p.shape)
        elif p.dim() == 1:  # norm scales are "weight", the rest biases
            v = torch.ones(p.shape) if name.endswith("weight") \
                else torch.zeros(p.shape)
        elif name.endswith("init_latents"):
            v = torch.randn(p.shape, generator=generator, dtype=torch.float64)
        elif id(p) in dino and name.endswith("cls_token"):
            v = torch.zeros(p.shape)
        elif id(p) in dino and name.endswith("position_embeddings"):
            v = 0.02 * torch.randn(p.shape, generator=generator,
                                   dtype=torch.float64)
        elif id(p) in codebooks:
            n = p.shape[0]
            v = (2 * torch.rand(p.shape, generator=generator,
                                dtype=torch.float64) - 1) / n
        elif name.endswith("gru.weight_hh") or ".rnn.weight_hh_l" in name:
            v = _orthogonal_blocks(p.shape, generator)
        elif id(p) in ar:
            v = _variance_scaling(p.shape, ar[id(p)], generator)
        elif name.endswith("tok_emb.weight"):
            v = 0.02 * torch.randn(p.shape, generator=generator,
                                   dtype=torch.float64)
        elif name.endswith("pos_emb.pe"):
            v = _truncated_normal(p.shape, generator)
        elif id(p) in resnet:
            v = _variance_scaling(p.shape, RESNET_CONV, generator)
        elif id(p) in enc_convs:
            v = _variance_scaling(p.shape, CONV_BLOCK, generator)
        elif id(p) in deconvs:
            v = _variance_scaling(p.shape, CONV_BLOCK, generator,
                                  transposed=True)
        else:
            v = _variance_scaling(p.shape, LECUN_NORMAL, generator)
        p.copy_(v.to(p.dtype))
    return model
