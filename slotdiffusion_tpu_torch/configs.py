"""Flagship configuration of the port: SAViDiffusion on MOVi-E, 128x128.

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
  (the JAX default "auto" resolves to False).
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
    denoise_loss_w = 1.0
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
                timesteps=50, use_pallas=True):
    """The flagship's structure at narrow widths, for CPU runs and tests:
    GN-ResNet18 encoder, 2-iteration SA, 1-layer predictor, a 2-level UNet
    with attention at both levels, a 3-level VQ-VAE with 64 codes, no
    dropout, 2 clips a step; the three kernel knobs as in the flagship."""
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
        resolution=tuple(resolution),
        slot_dict=dict(num_slots=num_slots, slot_size=slot_size,
                       slot_mlp_size=2 * slot_size, num_iterations=2,
                       use_pallas=use_pallas),
        enc_dict=dict(SAViLDMMoviE128.enc_dict,
                      enc_out_channels=slot_size),
        dec_dict=dec,
        pred_dict=dict(SAViLDMMoviE128.pred_dict, pred_num_layers=1,
                       pred_num_heads=2, pred_ffn_dim=2 * slot_size))
