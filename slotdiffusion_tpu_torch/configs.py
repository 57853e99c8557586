"""Configurations of the port: the flagship SAViDiffusion on MOVi-E,
128x128 (`SAViLDMMoviE128`), and the repo's trained 64x64 SAViDiffusion
(`SAViLDMMoviFile64`).

An own copy of the settings of the JAX package's `configs_base.py:17-140,
274-330` and `configs/video_based/savi_ldm/savi_ldm_movie_params-res128.py`
(the port imports nothing of the JAX package), with `BaseParams` copied
from the JAX package's `utils/config.py`. The training settings are
`SAViLDMBase`'s (`configs_base.py:308-330`). The JAX config names an orbax
stage-1 VQ-VAE (`vqvae_ckp_path`), which the port cannot read; the port's
config leaves it unset (a random VQ-VAE), and a user points
`dec_dict["vae_dict"]["vqvae_ckp_path"]` at a port-format file
(`training/checkpoint.py:graft_pretrained`).

Three knobs differ from the JAX flagship, and they are why the port's
main path runs its kernels:

- `fused_gn=True`: every UNet ResBlock GN+SiLU and SpatialTransformer GN
  runs the GN(+SiLU) kernel (the JAX default is False);
- `attn_backend="fused"`: every UNet self- and cross-attention runs the
  attention kernel (the JAX default is "einsum"). The kernel's softmax is
  the clamped-exp form, so `attn_softmax` is ignored on this path, as in
  the JAX package;
- `use_pallas=True`: every SAVi frame runs the slot-attention kernel
  (the JAX default "auto" resolves to False, in the port as in the JAX
  package).

`use_bf16` (False, the JAX default; `scripts/train.py --bf16` of the JAX
package, `scripts/train_torch.py --bf16` here) builds the model in bf16 as
the JAX package does: f32 parameters, each layer computing in bf16
(`models/blocks.py`), the GN and attention kernels through their bf16
entry points.
"""

import copy


class BaseParams:
    """Mutable attribute-bag config: class attributes are defaults,
    keyword arguments override them."""

    def __init__(self, **overrides):
        for k, v in overrides.items():
            setattr(self, k, v)

    def copy(self, **overrides):
        new = copy.deepcopy(self)
        for k, v in overrides.items():
            setattr(new, k, v)
        return new


def vae_dict_for(resolution, img_ch=3, latent_ch=3):
    """Taming-style VQ-VAE, ch 64, ch_mult (1, 2, 4), 4096 codes."""
    return dict(
        vae_type="VQVAE",
        enc_dec_dict=dict(
            resolution=resolution[0], in_channels=img_ch,
            z_channels=latent_ch, ch=64, ch_mult=[1, 2, 4],
            num_res_blocks=2, attn_resolutions=[], out_ch=img_ch,
            dropout=0.0),
        vq_dict=dict(n_embed=4096, embed_dim=latent_ch),
    )


def ldm_unet_dict(slot_size, latent_ch=3):
    return dict(
        in_channels=latent_ch, model_channels=128, out_channels=latent_ch,
        num_res_blocks=2, attention_resolutions=(8, 4, 2), dropout=0.1,
        channel_mult=(1, 2, 3, 4), num_head_channels=32,
        context_dim=slot_size, attn_softmax="stable",
        fused_gn=True, attn_backend="fused")


def ldm_dec_dict(resolution, slot_size, latent_ch=3, timesteps=1000):
    return dict(
        resolution=tuple(r // 4 for r in resolution),
        vae_dict=vae_dict_for(resolution, latent_ch=latent_ch),
        unet_dict=ldm_unet_dict(slot_size, latent_ch),
        diffusion_dict=dict(
            pred_target="eps", z_scale_factor=1.0, timesteps=timesteps,
            beta_schedule="linear", linear_start=0.0015,
            linear_end=0.0195),
        conditioning_key="crossattn")


class SAViLDMMoviE128(BaseParams):
    """SAViDiffusion on MOVi-E at 128x128 (savi_ldm_movie_params-res128)."""
    # training (SAViLDMBase, and the JAX trainer's defaults)
    seed = 0
    max_epochs = 30
    save_interval = 0.1   # of an epoch
    print_iter = 50
    lr = 1e-4
    dec_lr = 2e-4         # the dm_decoder group's max LR
    min_lr = 0.0
    clip_grad = 0.05      # <= 0: no clipping
    warmup_steps_pct = 0.05
    grad_accum_steps = 1
    use_ema = False       # an EMA of the dm_decoder, swapped in at eval
    ema_decay = 0.9999
    train_batch_size = 32
    val_batch_size = 32
    eval_interval = 1     # epochs between validations
    denoise_loss_w = 1.0
    use_bf16 = False      # compute dtype bf16, parameters f32
    # data (configs_base.py:_VideoCommon, _Common)
    dataset = "movi"
    movi_level = "e"
    data_root = "./data/MOVi"
    frame_offset = 1
    video_len = 24
    load_mask = True
    num_workers = 8
    # model
    model = "SAViDiffusion"
    resolution = (128, 128)
    n_sample_frames = 6
    slot_dict = dict(num_slots=15, slot_size=192, slot_mlp_size=384,
                     num_iterations=2, use_pallas=True)
    enc_dict = dict(resnet="resnet18", use_layer4=False,
                    enc_out_channels=192,
                    replace_stride_with_dilation=[False, False, False])
    dec_dict = ldm_dec_dict((128, 128), 192)
    pred_dict = dict(pred_type="transformer", pred_rnn=False,
                     pred_norm_first=True, pred_num_layers=2,
                     pred_num_heads=4, pred_ffn_dim=192 * 4)


def tiny_config(resolution=(16, 16), num_slots=3, slot_size=32,
                timesteps=50, use_pallas=True, use_bf16=False):
    """The flagship's structure at narrow widths, for CPU runs and tests:
    GN-ResNet18 encoder, 2-iteration SA, 1-layer predictor, a 2-level UNet
    with attention at both levels, a 3-level VQ-VAE with 64 codes, no
    dropout, 2 clips a step; the three kernel knobs as in the flagship,
    and the compute dtype `use_bf16` asks for."""
    unet = dict(ldm_unet_dict(slot_size), model_channels=32,
                num_res_blocks=1, attention_resolutions=(1, 2),
                channel_mult=(1, 2), num_head_channels=32, dropout=0.0)
    vae = vae_dict_for(resolution)
    vae["enc_dec_dict"] = dict(vae["enc_dec_dict"], ch=8)
    vae["vq_dict"] = dict(n_embed=64, embed_dim=3)
    dec = ldm_dec_dict(resolution, slot_size, timesteps=timesteps)
    dec.update(unet_dict=unet, vae_dict=vae)
    return SAViLDMMoviE128().copy(
        train_batch_size=2,
        use_bf16=use_bf16,
        resolution=tuple(resolution),
        slot_dict=dict(num_slots=num_slots, slot_size=slot_size,
                       slot_mlp_size=2 * slot_size, num_iterations=2,
                       use_pallas=use_pallas),
        enc_dict=dict(SAViLDMMoviE128.enc_dict,
                      enc_out_channels=slot_size),
        dec_dict=dec,
        pred_dict=dict(SAViLDMMoviE128.pred_dict, pred_num_layers=1,
                       pred_num_heads=2, pred_ffn_dim=2 * slot_size))


class SAViLDMMoviFile64(SAViLDMMoviE128):
    """The repo's trained SAViDiffusion: an own copy of the JAX package's
    `configs/savi_ldm_movi_file-res64.py` over its base
    `configs/savi_ldm_synthetic_params-res64.py`, whose checkpoint
    `checkpoint/savi_ldm_movi_file-res64/ckpt_final` the export script
    (`scripts/export_torch_checkpoint.py`) carries into the port.

    64x64 clips of 2 frames from a MOVi-layout tree (JPEG frames,
    grayscale PNG masks, `scripts/gen_movi_tree.py`); 6 slots of 64; the
    plain CNN encoder (3 -> 32 -> 32 -> 32, 5x5, stride 1, no norm); a
    1-layer transformer predictor; a UNet of 32 channels, mult (1, 2),
    attention at (4, 2), heads 8 wide, 200 timesteps, with an EMA of the
    decoder; the VQ-VAE of ch 32, mult (1, 2), 512 codes.

    The JAX config runs no Pallas kernel, and this copy keeps its knobs:
    `use_pallas="auto"`, `fused_gn=False`, `attn_backend="einsum"`. On
    every device it computes what the JAX model computes: slot attention
    in f32 ("auto" resolves to the f32 formula, as in the JAX package),
    GroupNorm and attention in their plain PyTorch versions (the UNet's
    heads are 8 wide, and the attention kernel takes 32). `vqvae_ckp_path`
    is unset: a converted SAViDiffusion
    checkpoint carries its VQ-VAE, and a training run names a port-format
    VQ-VAE file (`scripts/train_torch.py --vqvae_ckp_path`).
    """
    max_epochs = 32
    save_interval = 8.0
    eval_interval = 2
    print_iter = 64
    use_ema = False
    train_batch_size = 8
    val_batch_size = 8
    dataset = "movi"
    movi_level = "e"
    data_root = "data_local/movi_file"
    video_len = 6
    n_sample_frames = 2
    frame_offset = 1
    load_mask = True
    num_workers = 4
    resolution = (64, 64)
    # "auto": slot attention's f32 formula on every device, as in the JAX
    # package
    slot_dict = dict(num_slots=6, slot_size=64, slot_mlp_size=128,
                     num_iterations=2, use_pallas="auto")
    enc_dict = dict(enc_channels=(3, 32, 32, 32), enc_ks=5,
                    enc_out_channels=64, enc_norm="")
    pred_dict = dict(pred_type="transformer", pred_rnn=False,
                     pred_norm_first=True, pred_num_layers=1,
                     pred_num_heads=2, pred_ffn_dim=128)
    dec_dict = dict(
        resolution=(32, 32),
        unet_dict=dict(
            in_channels=3, model_channels=32, out_channels=3,
            num_res_blocks=1, attention_resolutions=(4, 2), dropout=0.0,
            channel_mult=(1, 2), num_head_channels=8, context_dim=64),
        vae_dict=dict(
            vae_type="VQVAE",
            enc_dec_dict=dict(
                resolution=64, in_channels=3, z_channels=3, ch=32,
                ch_mult=[1, 2], num_res_blocks=1, attn_resolutions=[],
                out_ch=3, dropout=0.0),
            vq_dict=dict(n_embed=512, embed_dim=3)),
        use_ema=True,
        diffusion_dict=dict(
            pred_target="eps", z_scale_factor=1.0, timesteps=200,
            beta_schedule="linear", linear_start=0.0015,
            linear_end=0.0195),
        conditioning_key="crossattn")


CONFIGS = {"SAViLDMMoviE128": SAViLDMMoviE128,
           "SAViLDMMoviFile64": SAViLDMMoviFile64}


def get_config(name):
    """A config of the port by its class name."""
    if name not in CONFIGS:
        raise ValueError(f"unknown config {name!r}: one of {sorted(CONFIGS)}")
    return CONFIGS[name]()
